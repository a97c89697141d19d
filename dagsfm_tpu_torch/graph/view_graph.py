"""View graph: image nodes and two-view geometry edges (host bookkeeping).

Port of dagsfm_tpu/graph/view_graph.py: largest connected component,
Kruskal maximum spanning tree and the triplet rotation-cycle filter.
The graph stays on the host; the cycle check composes every triplet's
rotations in one batched call on the caller's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dagsfm_tpu_torch import device as devmod


@dataclasses.dataclass
class TwoViewEdge:
    """Edge payload: R_12 with R_2 = R_12 @ R_1, and the t direction."""
    image_id1: int
    image_id2: int
    rotation: np.ndarray        # (3, 3)
    position: np.ndarray        # (3,)
    num_inliers: int
    visibility_score: float = 0.0


class UnionFind:
    """Disjoint sets with path compression and union by rank."""

    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


class ViewGraph:
    def __init__(self):
        self.edges: dict[tuple, TwoViewEdge] = {}
        self.nodes: set = set()

    def add_edge(self, edge: TwoViewEdge) -> None:
        """Store the edge as (i, j) with i < j, inverting the relative
        geometry when it comes the other way round."""
        i, j = edge.image_id1, edge.image_id2
        assert i != j
        if i > j:
            edge = TwoViewEdge(j, i, edge.rotation.T,
                               -edge.rotation @ edge.position,
                               edge.num_inliers, edge.visibility_score)
            i, j = j, i
        self.edges[(i, j)] = edge
        self.nodes.add(i)
        self.nodes.add(j)

    def neighbors(self, i: int):
        for (a, b) in self.edges:
            if a == i:
                yield b
            elif b == i:
                yield a

    def num_edges(self) -> int:
        return len(self.edges)

    def largest_connected_component(self) -> set:
        """Node set of the largest connected component (the first of the
        largest in node order)."""
        ids = sorted(self.nodes)
        index = {v: k for k, v in enumerate(ids)}
        uf = UnionFind(len(ids))
        for (i, j) in self.edges:
            uf.union(index[i], index[j])
        groups: dict[int, list] = {}
        for v in ids:
            groups.setdefault(uf.find(index[v]), []).append(v)
        if not groups:
            return set()
        return set(max(groups.values(), key=len))

    def subgraph(self, keep: set) -> "ViewGraph":
        out = ViewGraph()
        out.nodes = set(keep)
        for (i, j), e in self.edges.items():
            if i in keep and j in keep:
                out.edges[(i, j)] = e
        return out

    def maximum_spanning_tree(self, weight=lambda e: e.num_inliers):
        """Kruskal maximum-weight spanning tree (stable on ties); returns
        the edge keys."""
        ids = sorted(self.nodes)
        index = {v: k for k, v in enumerate(ids)}
        uf = UnionFind(len(ids))
        out = []
        for key, e in sorted(self.edges.items(),
                             key=lambda kv: -weight(kv[1])):
            i, j = key
            if uf.find(index[i]) != uf.find(index[j]):
                uf.union(index[i], index[j])
                out.append(key)
        return out

    def triplets(self):
        """Every edge triangle (i, j, k), i < j < k, in edge order."""
        adj: dict[int, set] = {}
        for (i, j) in self.edges:
            adj.setdefault(i, set()).add(j)
            adj.setdefault(j, set()).add(i)
        out = []
        for (i, j) in self.edges:
            for k in adj[i] & adj[j]:
                if k > j:
                    out.append((i, j, k))
        return out

    def filter_cycles_by_rotation(self, max_angle_deg: float = 5.0,
                                  device=None) -> int:
        """Drop the edges of which no triplet closes: an edge stays if one
        of its triplets has R_ki @ R_jk @ R_ij within max_angle_deg of the
        identity (edges in no triplet go too). Every triplet's cycle is
        composed in one call on `device` (the GPU unless told "cpu").
        Returns the number of edges dropped."""
        dev = devmod.resolve(device)
        tris = self.triplets()
        if not tris:
            n = len(self.edges)
            self.edges = {}
            return n
        R12 = np.stack([self._rel(i, j) for (i, j, k) in tris])
        R23 = np.stack([self._rel(j, k) for (i, j, k) in tris])
        R31 = np.stack([self._rel(k, i) for (i, j, k) in tris])
        t = (lambda a: devmod.as_tensor(a, dev))
        cyc = t(R31) @ t(R23) @ t(R12)
        tr = cyc.diagonal(dim1=-2, dim2=-1).sum(-1).cpu().numpy()
        ang = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))
        good_tri = ang < max_angle_deg
        keep: set = set()
        for n, (i, j, k) in enumerate(tris):
            if good_tri[n]:
                keep.update({tuple(sorted((i, j))), tuple(sorted((j, k))),
                             tuple(sorted((i, k)))})
        before = len(self.edges)
        self.edges = {k: v for k, v in self.edges.items() if k in keep}
        return before - len(self.edges)

    def _rel(self, i: int, j: int) -> np.ndarray:
        """R_ij with R_j = R_ij @ R_i, from the stored edge."""
        if i < j:
            return self.edges[(i, j)].rotation
        return self.edges[(j, i)].rotation.T
