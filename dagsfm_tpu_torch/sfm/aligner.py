"""Cluster merging: Sim(3)-align per-cluster reconstructions into one.

Port of dagsfm_tpu/sfm/aligner.py: a graph of the reconstructions whose
edge weight is the larger of the two directional RANSAC-Sim(3) mean
alignment errors over their common 3D points, its largest connected
component, the minimum-error spanning tree, the anchor by leaf peeling,
Sim(3) paths composed to the anchor, and every reconstruction folded
into the anchor by `Reconstruction.merge`. Separator images (registered
in more than one cluster) are recorded.

The RANSAC runs as one batch on the aligner's device. Its samples come
from a `torch.Generator` seeded with `AlignerOptions.seed`, one set per
`find_similarity` call in `construct_graph`'s order, drawn by
`_sample_indices` (the reference's jax.random stream cannot be
replayed). The reference pads the points to a power of two, a TPU shape
bucket: the port passes exact sizes, which changes neither the inliers
nor the mean error.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.graph.view_graph import UnionFind
from dagsfm_tpu_torch.ops.umeyama import ransac_umeyama, sample_triplets
from dagsfm_tpu_torch.scene.reconstruction import Reconstruction


@dataclasses.dataclass
class AlignerOptions:
    min_common_points: int = 10
    ransac_threshold: float = 0.1    # relative to scene scale
    ransac_iters: int = 256
    max_edge_error: float = 1e9      # keep all edges, MST picks best
    seed: int = 0


@dataclasses.dataclass
class Sim3:
    scale: float
    R: np.ndarray
    t: np.ndarray

    def apply(self, x: np.ndarray) -> np.ndarray:
        return self.scale * x @ self.R.T + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        """self ∘ other: apply other first, then self."""
        return Sim3(self.scale * other.scale,
                    self.R @ other.R,
                    self.scale * self.R @ other.t + self.t)

    @staticmethod
    def identity() -> "Sim3":
        return Sim3(1.0, np.eye(3), np.zeros(3))

    def inverse(self) -> "Sim3":
        Rinv = self.R.T
        s = 1.0 / self.scale
        return Sim3(s, Rinv, -s * Rinv @ self.t)


def find_common_points(rec_a: Reconstruction, rec_b: Reconstruction):
    """3D point pairs observed at the same (image name, keypoint) in both.

    Ref: SfMAligner::FindCommon3DPoints (sfm_aligner.cpp:96-123).
    Returns (Xa (N,3), Xb (N,3)).
    """
    common = rec_a.find_common_reg_image_ids(rec_b)
    xa, xb = [], []
    seen = set()
    for (ia, ib) in common:
        im_a = rec_a.images[ia]
        im_b = rec_b.images[ib]
        K = min(len(im_a.point3D_ids), len(im_b.point3D_ids))
        for k in range(K):
            pa = int(im_a.point3D_ids[k])
            pb = int(im_b.point3D_ids[k])
            if pa < 0 or pb < 0:
                continue
            if (pa, pb) in seen:
                continue
            seen.add((pa, pb))
            xa.append(rec_a.points3D[pa].xyz)
            xb.append(rec_b.points3D[pb].xyz)
    if not xa:
        return np.zeros((0, 3)), np.zeros((0, 3))
    return np.stack(xa), np.stack(xb)


def find_similarity(xa: np.ndarray, xb: np.ndarray, opts: AlignerOptions,
                    sample_idx: torch.Tensor) -> tuple:
    """RANSAC Sim(3) xb ≈ s R xa + t on the device of `sample_idx`
    ((ransac_iters, 3) rows of xa). Returns (Sim3, mean inlier error);
    the error is inf with fewer than 3 inliers."""
    dev = sample_idx.device
    scale = np.abs(xb - xb.mean(0)).mean() + 1e-9
    s, R, t, inl, _ = ransac_umeyama(
        devmod.as_tensor(xa, dev), devmod.as_tensor(xb, dev),
        torch.ones(len(xa), dtype=torch.bool, device=dev), sample_idx,
        opts.ransac_threshold * scale)
    s = float(s)
    R = R.cpu().numpy()
    t = t.cpu().numpy()
    err = np.linalg.norm(s * xa @ R.T + t - xb, axis=1)
    inl_np = inl.cpu().numpy()
    if inl_np.sum() < 3:
        return Sim3(s, R, t), np.inf
    return Sim3(s, R, t), float(err[inl_np].mean())


class SfMAligner:
    """Merges `reconstructions`: the others are folded into the anchor's
    in place, which becomes the merged model. `device` is where the
    RANSAC runs: the GPU unless "cpu" is asked for."""

    def __init__(self, reconstructions: list,
                 options: AlignerOptions | None = None, device=None):
        self.recs = reconstructions
        self.opts = options or AlignerOptions()
        self.device = devmod.resolve(device)
        self.sim3 = {}           # (a, b) -> Sim3 mapping a-coords -> b-coords
        self.edge_err = {}
        self.separators: set = set()   # image names in >1 cluster
        self.anchor = None
        self.paths = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.opts.seed)

    def _sample_indices(self, n: int) -> torch.Tensor:
        """(ransac_iters, 3) samples over n correspondences."""
        return sample_triplets(
            self._gen, torch.ones(n, dtype=torch.bool, device=self.device),
            self.opts.ransac_iters)

    # -------------------------------------------------------------- graph
    def construct_graph(self):
        n = len(self.recs)
        for a in range(n):
            for b in range(a + 1, n):
                xa, xb = find_common_points(self.recs[a], self.recs[b])
                if len(xa) < self.opts.min_common_points:
                    continue
                s_ab, e_ab = find_similarity(xa, xb, self.opts,
                                             self._sample_indices(len(xa)))
                s_ba, e_ba = find_similarity(xb, xa, self.opts,
                                             self._sample_indices(len(xb)))
                w = max(e_ab, e_ba)   # ref :293-298
                if w > self.opts.max_edge_error:
                    continue
                self.sim3[(a, b)] = s_ab
                self.sim3[(b, a)] = s_ba
                self.edge_err[(a, b)] = w
                # separators: shared registered image names
                names_a = {self.recs[a].images[i].name
                           for i in self.recs[a].reg_image_ids}
                names_b = {self.recs[b].images[i].name
                           for i in self.recs[b].reg_image_ids}
                self.separators |= names_a & names_b

    def _largest_cc(self):
        n = len(self.recs)
        uf = UnionFind(n)
        for (a, b) in self.edge_err:
            uf.union(a, b)
        groups: dict[int, list] = {}
        for v in range(n):
            groups.setdefault(uf.find(v), []).append(v)
        return max(groups.values(), key=len) if groups else []

    def _mst(self, keep: set):
        uf = UnionFind(len(self.recs))
        out = []
        for (a, b), w in sorted(self.edge_err.items(), key=lambda kv: kv[1]):
            if a not in keep or b not in keep:
                continue
            if uf.find(a) != uf.find(b):
                uf.union(a, b)
                out.append((a, b))
        return out

    @staticmethod
    def _find_anchor(mst_edges, keep):
        """Iterative leaf peeling (ref :329-385)."""
        adj: dict[int, set] = {v: set() for v in keep}
        for (a, b) in mst_edges:
            adj[a].add(b)
            adj[b].add(a)
        alive = set(keep)
        while len(alive) > 1:
            leaves = [v for v in alive if len(adj[v] & alive) <= 1]
            if len(leaves) == len(alive):
                # last two nodes: pick the higher-degree one in the full MST
                return max(alive, key=lambda v: len(adj[v]))
            for v in leaves:
                alive.discard(v)
        return next(iter(alive))

    # -------------------------------------------------------------- align
    def align(self) -> Reconstruction:
        """Run the full merge. Returns the merged anchor reconstruction."""
        if len(self.recs) == 1:
            self.anchor = 0
            return self.recs[0]
        self.construct_graph()
        keep = self._largest_cc()
        if not keep:
            self.anchor = 0
            return self.recs[0]
        mst = self._mst(set(keep))
        self.anchor = self._find_anchor(mst, set(keep))

        # BFS from anchor composing Sim3 child->anchor (ref ComputePath :387)
        adj: dict[int, list] = {v: [] for v in keep}
        for (a, b) in mst:
            adj[a].append(b)
            adj[b].append(a)
        self.paths = {self.anchor: Sim3.identity()}
        stack = [self.anchor]
        while stack:
            v = stack.pop()
            for u in adj[v]:
                if u in self.paths:
                    continue
                # sim3[(u, v)] maps u-coords into v-coords
                self.paths[u] = self.paths[v].compose(self.sim3[(u, v)])
                stack.append(u)

        merged = self.recs[self.anchor]
        for v in keep:
            if v == self.anchor:
                continue
            sim = self.paths[v]
            merged.merge(self.recs[v], sim.scale, sim.R, sim.t)
        return merged

    def separator_image_ids(self, merged: Reconstruction) -> list:
        return [i for i, im in merged.images.items()
                if im.name in self.separators and im.registered]
