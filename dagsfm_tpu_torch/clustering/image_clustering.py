"""Partition and expand: cut the image graph, re-add the lost edges.

Port of dagsfm_tpu/clustering/image_clustering.py: `cut` (one k-way
cut; intra-cluster edges kept, cross edges collected as lost), `expand`
(lost edges re-added strongest first to the smaller incident cluster
until the completeness ratio), `expand_all_edges`, the iterative
`bicut` / `cut_and_expand`, the HYBRID re-cut of oversized communities
and the adaptive switch by degree spread. Host logic; the spectral cut
runs on the clustering's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.clustering.community import community_detection
from dagsfm_tpu_torch.clustering.spectral import spectral_cluster
from dagsfm_tpu_torch.graph import native


@dataclasses.dataclass
class ClusteringOptions:
    """Defaults mirror ref image_clustering.h:124-151."""
    num_images_ub: int = 100
    completeness_ratio: float = 0.5
    image_overlap: int = 50
    relax_ratio: float = 1.3
    branching_factor: int = 2        # ref branching_factor (BiCut fanout)
    cluster_type: str = "SPECTRAL"   # SPECTRAL | NCUT | COMMUNITY | HYBRID
    # adaptive switch: degree stddev above which HYBRID is used
    # (ref: sigma = 4.0, image_clustering.cpp:419-449)
    degree_sigma_switch: float = 4.0
    seed: int = 0


@dataclasses.dataclass
class ImageCluster:
    """One cluster: node ids + its (intra) edges (ref ImageCluster :55)."""
    cluster_id: int
    image_ids: list
    edges: dict          # (i, j) -> weight


class ImageClustering:
    """Cut-and-expand over a weighted image match graph.

    nodes: list of image ids; edges: dict (i, j) -> weight (num inliers).
    `device` is where spectral cuts run: the GPU unless "cpu" is asked
    for.
    """

    def __init__(self, nodes: list, edges: dict,
                 options: ClusteringOptions | None = None, device=None):
        self.opts = options or ClusteringOptions()
        self.device = devmod.resolve(device)
        self.nodes = sorted(nodes)
        self.edges = {self._canon(k): float(v) for k, v in edges.items()}
        self.clusters: list[ImageCluster] = []
        self.lost_edges: list = []     # [(w, i, j)]
        self.summary = {}

    @staticmethod
    def _canon(k):
        i, j = k
        return (i, j) if i < j else (j, i)

    # ------------------------------------------------------------------- cut
    def _labels(self, num_clusters: int) -> np.ndarray:
        return self._sub_labels(self.nodes, self.edges, num_clusters)

    def _sub_labels(self, nodes: list, edges: dict,
                    num_clusters: int) -> np.ndarray:
        index = {v: k for k, v in enumerate(nodes)}
        earr = np.array([(index[i], index[j]) for (i, j) in edges],
                        np.int32)
        warr = np.array(list(edges.values()))
        return self._dispatch_labels(nodes, earr, warr, num_clusters)

    def _dispatch_labels(self, nodes, earr, warr,
                         num_clusters: int) -> np.ndarray:
        ctype = self.opts.cluster_type.upper()
        if ctype == "HYBRID" or ctype == "COMMUNITY":
            labels = community_detection(earr, warr, len(nodes))
            if ctype == "HYBRID":
                # re-cut oversized communities spectrally
                # (ref hybrid_cluster.cpp:43-110)
                labels = labels.copy()
                next_label = labels.max() + 1
                for c in np.unique(labels):
                    members = np.nonzero(labels == c)[0]
                    if len(members) <= self.opts.num_images_ub:
                        continue
                    sub_k = int(np.ceil(len(members)
                                        / self.opts.num_images_ub))
                    mset = set(members.tolist())
                    sel = [e for e, (a, b) in enumerate(earr)
                           if a in mset and b in mset]
                    remap = {m: x for x, m in enumerate(members)}
                    sub_edges = np.array([(remap[earr[e, 0]],
                                           remap[earr[e, 1]])
                                          for e in sel], np.int32)
                    sub_w = warr[sel]
                    sub_labels = spectral_cluster(
                        sub_edges, sub_w, len(members), sub_k,
                        seed=self.opts.seed, device=self.device)
                    for m, sl in zip(members, sub_labels):
                        labels[m] = next_label + sl
                    next_label += sub_k
                # densify
                _, labels = np.unique(labels, return_inverse=True)
            return labels
        if ctype == "NCUT":
            # the native multilevel cut; spectral if the library is absent
            return native.ncut(len(nodes), earr.astype(np.int64),
                               warr, num_clusters, seed=self.opts.seed,
                               device=self.device).astype(np.int64)
        return spectral_cluster(earr, warr, len(nodes), num_clusters,
                                seed=self.opts.seed, device=self.device)

    def adaptive_cluster_type(self) -> str:
        """Degree-variance switch (ref CreateCluster :419-449)."""
        deg = {}
        for (i, j) in self.edges:
            deg[i] = deg.get(i, 0) + 1
            deg[j] = deg.get(j, 0) + 1
        d = np.array([deg.get(v, 0) for v in self.nodes], float)
        sigma = d.std()
        return "HYBRID" if sigma > self.opts.degree_sigma_switch \
            else self.opts.cluster_type

    def cut(self) -> list:
        """One k-way cut, k = ceil(N / num_images_ub) (ref Cut :68)."""
        k = max(1, int(np.ceil(len(self.nodes) / self.opts.num_images_ub)))
        labels = self._labels(k)
        index = {v: n for n, v in enumerate(self.nodes)}
        groups: dict[int, list] = {}
        for v in self.nodes:
            groups.setdefault(int(labels[index[v]]), []).append(v)
        self.clusters = [
            ImageCluster(ci, sorted(m), {})
            for ci, m in enumerate(groups.values())]
        label_of = {}
        for c in self.clusters:
            for v in c.image_ids:
                label_of[v] = c.cluster_id
        self.lost_edges = []
        for (i, j), w in self.edges.items():
            if label_of[i] == label_of[j]:
                self.clusters[label_of[i]].edges[(i, j)] = w
            else:
                self.lost_edges.append((w, i, j))
        self.lost_edges.sort(key=lambda t: -t[0])
        self.summary["num_clusters"] = len(self.clusters)
        self.summary["num_lost_edges"] = len(self.lost_edges)
        return self.clusters

    # ---------------------------------------------------------------- expand
    def expand(self) -> list:
        """Re-add lost edges (strongest first) to the smaller incident
        cluster while completeness unmet and overlap budget remains
        (ref Expand :131-199 + AddLostEdgesBetweenClusters :563-626)."""
        if not self.clusters:
            self.cut()
        member_of: dict[int, set] = {v: set() for v in self.nodes}
        for c in self.clusters:
            for v in c.image_ids:
                member_of[v].add(c.cluster_id)
        base_sizes = {c.cluster_id: len(c.image_ids) for c in self.clusters}
        max_size = int(self.opts.num_images_ub * self.opts.relax_ratio)
        # per-cluster budget of added (repeated) images
        added = {c.cluster_id: 0 for c in self.clusters}
        target = {
            c.cluster_id: int(self.opts.completeness_ratio
                              * self.opts.image_overlap)
            for c in self.clusters}

        recovered = 0
        for (w, i, j) in self.lost_edges:
            ci = next(iter(member_of[i]))
            cj = next(iter(member_of[j]))
            # pick smaller incident cluster to receive the foreign image
            csmall, vnew = ((ci, j) if base_sizes[ci] <= base_sizes[cj]
                            else (cj, i))
            c = self.clusters[csmall]
            if vnew in c.image_ids:
                c.edges[self._canon((i, j))] = w
                recovered += 1
                continue
            if added[csmall] >= min(self.opts.image_overlap,
                                    max_size - base_sizes[csmall]):
                continue
            if added[csmall] >= target[csmall] and \
                    added[csmall] >= self.opts.image_overlap:
                continue
            c.image_ids.append(vnew)
            c.image_ids.sort()
            c.edges[self._canon((i, j))] = w
            member_of[vnew].add(csmall)
            added[csmall] += 1
            recovered += 1
        self.summary["num_recovered_edges"] = recovered
        self.summary["overlap_added"] = dict(added)
        return self.clusters

    # ----------------------------------------------------- bicut variant
    def bicut(self, cluster: ImageCluster) -> list:
        """One branching_factor-way cut of a single cluster; cross edges
        go to the discarded-edge heap (ref BiCut, image_clustering.cpp:
        249-288)."""
        import heapq
        bf = self.opts.branching_factor
        if len(cluster.image_ids) <= 1 or not cluster.edges:
            return [ImageCluster(0, list(cluster.image_ids),
                                 dict(cluster.edges))]
        labels = self._sub_labels(cluster.image_ids, cluster.edges, bf)
        index = {v: n for n, v in enumerate(cluster.image_ids)}
        children = [ImageCluster(k, [], {}) for k in range(bf)]
        for v in cluster.image_ids:
            children[int(labels[index[v]])].image_ids.append(v)
        for (i, j), w in cluster.edges.items():
            li, lj = int(labels[index[i]]), int(labels[index[j]])
            if li == lj:
                children[li].edges[(i, j)] = w
            else:
                heapq.heappush(self._discarded, (-w, i, j))
        return [c for c in children if c.image_ids]

    def cut_and_expand(self) -> list:
        """Iterative BiCut + graph-expansion variant from the paper
        (ref CutAndExpand, image_clustering.cpp:290-369): recursively
        bisect oversized clusters, then re-add discarded edges to any
        cluster still under the completeness-ratio overlap bound,
        re-splitting clusters that grew past relax_ratio * ub."""
        import heapq
        from collections import deque

        self._discarded: list = []
        root = ImageCluster(0, list(self.nodes), dict(self.edges))
        queue = deque([root])
        inter: list = []
        iters = 0
        while queue and iters < 32:
            iters += 1
            while queue:
                c = queue.popleft()
                if len(c.image_ids) <= self.opts.num_images_ub:
                    inter.append(c)
                else:
                    queue.extend(self.bicut(c))
            # graph expansion: strongest discarded edges first
            while self._discarded:
                accepting = self._accepting_clusters(inter)
                if not any(accepting):
                    self._discarded = []
                    break
                negw, i, j = heapq.heappop(self._discarded)
                cid = self._cluster_for_edge(inter, accepting, i, j)
                if cid is None:
                    continue
                c = inter[cid]
                s = set(c.image_ids)
                vnew = i if i not in s else j
                if vnew not in s:
                    c.image_ids.append(vnew)
                c.edges[self._canon((i, j))] = -negw
            # regroup oversized clusters
            max_size = self.opts.relax_ratio * self.opts.num_images_ub
            keep = []
            for c in inter:
                if len(c.image_ids) > max_size:
                    queue.append(c)
                else:
                    keep.append(c)
            inter = keep
        for k, c in enumerate(inter):
            c.cluster_id = k
            c.image_ids.sort()
        self.clusters = inter
        self.summary["num_clusters"] = len(inter)
        self.summary["cut_and_expand_iters"] = iters
        return self.clusters

    def _accepting_clusters(self, inter: list) -> list:
        """Per-cluster flag: repeated-image ratio still below the
        completeness bound (ref ClusterSatisfyCompletenessRatio +
        IsRemainingClusters, image_clustering.cpp:451-509)."""
        sets = [set(c.image_ids) for c in inter]
        out = []
        for a, sa in enumerate(sets):
            repeated = set()
            for b, sb in enumerate(sets):
                if a != b:
                    repeated |= (sa & sb)
            out.append(len(repeated) / max(len(sa), 1)
                       <= self.opts.completeness_ratio)
        return out

    def _cluster_for_edge(self, inter, accepting, i, j):
        for idx, c in enumerate(inter[:-1] if len(inter) > 1 else inter):
            if not accepting[idx]:
                continue
            s = set(c.image_ids)
            if i in s or j in s:
                return idx
        return None

    def expand_all_edges(self) -> list:
        """Unconditionally assign every lost edge to one incident cluster
        (ref ExpandAllEdges :201-247, used for distributed matching so
        every pair gets matched exactly once)."""
        if not self.clusters:
            self.cut()
        member_of = {}
        for c in self.clusters:
            for v in c.image_ids:
                member_of.setdefault(v, c.cluster_id)
        for (w, i, j) in self.lost_edges:
            ci = member_of[i]
            cj = member_of[j]
            tgt = ci if len(self.clusters[ci].image_ids) <= \
                len(self.clusters[cj].image_ids) else cj
            c = self.clusters[tgt]
            for v in (i, j):
                if v not in c.image_ids:
                    c.image_ids.append(v)
            c.edges[self._canon((i, j))] = w
        for c in self.clusters:
            c.image_ids.sort()
        return self.clusters
