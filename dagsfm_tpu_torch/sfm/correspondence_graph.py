"""Correspondence graph: per-image keypoint match adjacency (host).

Copy of dagsfm_tpu/sfm/correspondence_graph.py (host numpy), kept in the
port so it imports nothing of the JAX package. Counterpart of COLMAP's
src/base/correspondence_graph.h.
This is graph-shaped bookkeeping, deliberately kept on host in numpy (it is
a tiny fraction of runtime — SURVEY.md §7 design stance); the batched
device kernels consume flat arrays exported from here.

Differences from the reference: correspondences are stored as per-pair
match arrays + per-image CSR adjacency instead of per-keypoint linked
lists — O(1) bulk export of "all matches of image i against registered
images", which is what the batched registration/triangulation kernels
want.
"""

from __future__ import annotations

import numpy as np


class CorrespondenceGraph:
    def __init__(self):
        self.num_keypoints: dict[int, int] = {}
        # (i, j) with i < j -> (M, 2) uint32 match array
        self.pair_matches: dict[tuple, np.ndarray] = {}
        self.neighbors: dict[int, set] = {}
        self._num_corrs: dict[int, np.ndarray] = {}  # per-keypoint degree
        # lazy per-keypoint CSR adjacency (invalidated by add_matches)
        self._kp_adj: dict[int, tuple] = {}

    def add_image(self, image_id: int, num_keypoints: int) -> None:
        self.num_keypoints[image_id] = num_keypoints
        self.neighbors.setdefault(image_id, set())
        self._num_corrs[image_id] = np.zeros(num_keypoints, np.int32)

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray) -> None:
        """matches: (M, 2) keypoint index pairs (col0 in image1)."""
        if image_id1 == image_id2 or len(matches) == 0:
            return
        if image_id1 > image_id2:
            image_id1, image_id2 = image_id2, image_id1
            matches = matches[:, ::-1]
        m = np.asarray(matches, np.uint32)
        self.pair_matches[(image_id1, image_id2)] = m
        self.neighbors[image_id1].add(image_id2)
        self.neighbors[image_id2].add(image_id1)
        np.add.at(self._num_corrs[image_id1], m[:, 0], 1)
        np.add.at(self._num_corrs[image_id2], m[:, 1], 1)
        self._kp_adj.pop(image_id1, None)
        self._kp_adj.pop(image_id2, None)

    def matches_between(self, image_id1: int, image_id2: int) -> np.ndarray:
        if image_id1 <= image_id2:
            return self.pair_matches.get((image_id1, image_id2),
                                         np.zeros((0, 2), np.uint32))
        m = self.pair_matches.get((image_id2, image_id1),
                                  np.zeros((0, 2), np.uint32))
        return m[:, ::-1]

    def num_correspondences_between(self, i: int, j: int) -> int:
        return len(self.matches_between(i, j))

    def num_correspondences_for_image(self, image_id: int) -> int:
        return int(self._num_corrs[image_id].sum())

    def num_observations_for_image(self, image_id: int) -> int:
        """Keypoints with >= 1 correspondence (ref: NumObservationsForImage)."""
        return int((self._num_corrs[image_id] > 0).sum())

    def image_pairs(self):
        return list(self.pair_matches.keys())

    def correspondences_of_image(self, image_id: int, others=None):
        """All (kp_idx, other_image, other_kp) rows for image_id.

        others: optional set restricting the neighbor images.
        Returns (K, 3) int64 array.
        """
        rows = []
        for j in sorted(self.neighbors.get(image_id, ())):
            if others is not None and j not in others:
                continue
            m = self.matches_between(image_id, j)
            if len(m) == 0:
                continue
            block = np.empty((len(m), 3), np.int64)
            block[:, 0] = m[:, 0]
            block[:, 1] = j
            block[:, 2] = m[:, 1]
            rows.append(block)
        if not rows:
            return np.zeros((0, 3), np.int64)
        return np.concatenate(rows, axis=0)

    def _kp_csr(self, image_id: int):
        """CSR over keypoints of image_id: (starts (K+1,), data (M, 2))
        with data rows = (other_image, other_kp), grouped by keypoint."""
        cached = self._kp_adj.get(image_id)
        if cached is not None:
            return cached
        corrs = self.correspondences_of_image(image_id)
        K = self.num_keypoints.get(image_id, 0)
        if len(corrs) == 0:
            out = (np.zeros(K + 1, np.int64), np.zeros((0, 2), np.int64))
            self._kp_adj[image_id] = out
            return out
        order = np.argsort(corrs[:, 0], kind="stable")
        kp_s = corrs[order, 0]
        data = corrs[order, 1:]
        starts = np.searchsorted(kp_s, np.arange(K + 1))
        out = (starts, data)
        self._kp_adj[image_id] = out
        return out

    def correspondences_of(self, image_id: int, kp: int) -> np.ndarray:
        """(K, 2) rows of (other_image, other_kp) for one keypoint
        (ref correspondence_graph.h FindCorrespondences)."""
        starts, data = self._kp_csr(image_id)
        if kp + 1 >= len(starts):
            return np.zeros((0, 2), np.int64)
        return data[starts[kp]: starts[kp + 1]]

    def find_transitive_correspondences(self, image_id: int, kp: int,
                                        transitivity: int = 1) -> np.ndarray:
        """BFS to depth `transitivity` over keypoint-correspondence edges
        (ref correspondence_graph.h:46-158 FindTransitiveCorrespondences).

        Returns (K, 2) rows of (other_image, other_kp), excluding the
        query keypoint, deduplicated, in discovery order.
        """
        if transitivity <= 1:
            return self.correspondences_of(image_id, kp)
        start = (image_id, int(kp))
        seen = {start}
        frontier = [start]
        found: list = []
        for _ in range(transitivity):
            nxt = []
            for (i, k) in frontier:
                for j, kj in self.correspondences_of(i, k):
                    node = (int(j), int(kj))
                    if node in seen:
                        continue
                    seen.add(node)
                    found.append(node)
                    nxt.append(node)
            if not nxt:
                break
            frontier = nxt
        if not found:
            return np.zeros((0, 2), np.int64)
        return np.array(found, np.int64)


def build_tracks(graph: CorrespondenceGraph, min_length: int = 2,
                 max_length: int = 50):
    """UnionFind track linking from pairwise matches.

    Ref: base/track_builder.h:52-75 (min 2 / max limits). Returns list of
    tracks, each a list[(image_id, kp_idx)]; tracks with internal
    conflicts (two keypoints of the same image) are dropped, matching the
    reference's consistency filter.
    """
    # element ids: (image, kp) -> dense index
    index = {}
    elems = []
    for (i, j), m in graph.pair_matches.items():
        for a, b in m:
            for key in ((i, int(a)), (j, int(b))):
                if key not in index:
                    index[key] = len(elems)
                    elems.append(key)
    parent = np.arange(len(elems))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for (i, j), m in graph.pair_matches.items():
        for a, b in m:
            ra, rb = find(index[(i, int(a))]), find(index[(j, int(b))])
            if ra != rb:
                parent[ra] = rb

    groups = {}
    for k, key in enumerate(elems):
        groups.setdefault(find(k), []).append(key)

    tracks = []
    for members in groups.values():
        if not (min_length <= len(members) <= max_length):
            continue
        imgs = [m[0] for m in members]
        if len(set(imgs)) != len(imgs):
            continue  # conflicting track
        tracks.append(sorted(members))
    return tracks
