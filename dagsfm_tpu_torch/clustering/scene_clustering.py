"""Hierarchical binary scene clustering (COLMAP's SceneClustering).

Port of dagsfm_tpu/clustering/scene_clustering.py: a normalized-cut
tree (branching 2 by default) over the image match graph, cut until each
leaf holds at most leaf_max_num_images, each child given back up to
image_overlap images across the cut by the strongest cross-cut edges.
Each cut is the spectral cut of clustering/spectral.py on `device` (the
GPU unless "cpu" is asked for); the recursion is host work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.clustering.spectral import spectral_cluster


@dataclasses.dataclass
class SceneClusteringOptions:
    """COLMAP's SceneClustering options."""
    branching: int = 2
    image_overlap: int = 50
    leaf_max_num_images: int = 500
    seed: int = 0


@dataclasses.dataclass
class ClusterNode:
    image_ids: list
    children: list          # list[ClusterNode], empty at leaves


class SceneClustering:
    """Binary cut tree with overlap re-added at each split."""

    def __init__(self, options: SceneClusteringOptions | None = None,
                 device=None):
        self.opts = options or SceneClusteringOptions()
        self.device = devmod.resolve(device)
        self.root: ClusterNode | None = None

    def partition(self, image_pairs: list, weights: list) -> None:
        """image_pairs: [(i, j)], weights: [w] (e.g. inlier counts)."""
        ids = sorted({i for p in image_pairs for i in p})
        edges = {}
        for (i, j), w in zip(image_pairs, weights):
            k = (i, j) if i < j else (j, i)
            edges[k] = edges.get(k, 0.0) + float(w)
        self.root = self._partition_cluster(ids, edges)

    def _partition_cluster(self, ids: list, edges: dict) -> ClusterNode:
        node = ClusterNode(image_ids=list(ids), children=[])
        if len(ids) <= self.opts.leaf_max_num_images or len(edges) == 0:
            return node
        index = {v: k for k, v in enumerate(ids)}
        earr = np.asarray([(index[i], index[j]) for (i, j) in edges],
                          np.int32)
        warr = np.asarray(list(edges.values()))
        labels = spectral_cluster(earr, warr, len(ids), self.opts.branching,
                                  seed=self.opts.seed, device=self.device)
        groups = [[ids[k] for k in np.nonzero(labels == c)[0]]
                  for c in range(self.opts.branching)]
        if sum(1 for g in groups if g) < 2:
            return node    # the cut did not split; a leaf

        # overlap: the strongest cross-cut edges re-add the far end point
        # to the near cluster (AddOverlappingImages)
        label_of = {ids[k]: int(labels[k]) for k in range(len(ids))}
        cross = sorted(
            ((w, i, j) for (i, j), w in edges.items()
             if label_of[i] != label_of[j]), reverse=True)
        added = [0] * self.opts.branching
        members = [set(g) for g in groups]
        for w, i, j in cross:
            for (a, b) in ((i, j), (j, i)):
                c = label_of[a]
                if added[c] < self.opts.image_overlap and \
                        b not in members[c]:
                    members[c].add(b)
                    groups[c].append(b)
                    added[c] += 1

        for g, mem in zip(groups, members):
            if not g:
                continue
            sub_edges = {(i, j): w for (i, j), w in edges.items()
                         if i in mem and j in mem}
            node.children.append(self._partition_cluster(sorted(g),
                                                         sub_edges))
        return node

    def leaf_clusters(self) -> list:
        """Every leaf node, depth first (GetLeafClusters)."""
        out = []

        def walk(n):
            if not n.children:
                out.append(n)
            for c in n.children:
                walk(c)

        if self.root is not None:
            walk(self.root)
        return out
