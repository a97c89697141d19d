"""Vocab-tree visual index: hierarchical k-means, inverted index with a
Hamming embedding, TF-IDF scoring and vote-and-verify.

Port of dagsfm_tpu/features/visual_index.py. The tree is a stack of
per-level centroid tensors; a descriptor descends by one product per
level against every child centroid of the level, then takes the columns
of its node's children. Tree descent, k-means, the Hamming signatures
and the signature distances of `_hamming_score` / `match_words` run on
the tree's device; TF-IDF scoring, ranking and `vote_and_verify` stay in
numpy as in the reference.

`build_vocab_tree` draws k-means' initial centroids from one
`torch.Generator` seeded with the seed, one `retrieval._draw_init` call
per node with more than `branching` descriptors, in the reference's node
order (the reference splits its key once per such node), so a test can
replay the reference's key chain. Its numpy draws keep the reference's
call order: `rng.integers` for small nodes inside the loop, then
`rng.standard_normal` for the projection.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.features import retrieval as rt

# (descriptors x a level's centroids) distance elements per descent chunk
_CHUNK_ELEMS = 1 << 24


class VocabTreeOptions(NamedTuple):
    branching: int = 8
    depth: int = 2                # levels; leaves = branching ** depth
    kmeans_iters: int = 15
    embedding_bits: int = 64      # Hamming embedding
    hamming_threshold: int = 24   # largest distance that counts as a vote
    sample_per_image: int = 256


class VocabTree(NamedTuple):
    """levels[l]: (B**l, B, D) centroids of each level-l node's children.
    A leaf's word id is the base-B digits of its descent path."""
    levels: tuple            # tensors on the tree's device
    proj: torch.Tensor       # (D, bits) random projection
    thresholds: torch.Tensor  # (num_words, bits) per-word medians

    @property
    def branching(self) -> int:
        return self.levels[0].shape[1]

    @property
    def num_words(self) -> int:
        return self.branching ** len(self.levels)


def tree_from_arrays(levels, proj, thresholds, device=None) -> VocabTree:
    """VocabTree on `device` from numpy arrays (or an `.npz`'s)."""
    dev = devmod.resolve(device)
    t = (lambda a: torch.as_tensor(np.array(a), dtype=torch.float32,
                                   device=dev))
    return VocabTree(tuple(t(lv) for lv in levels), t(proj), t(thresholds))


def save_tree(path: str, tree: VocabTree) -> None:
    """The `.npz` layout both packages read: proj, thresholds, level<k>."""
    np.savez(path, proj=tree.proj.cpu().numpy(),
             thresholds=tree.thresholds.cpu().numpy(),
             **{f"level{k}": lv.cpu().numpy()
                for k, lv in enumerate(tree.levels)})


def load_tree(path: str, device=None) -> VocabTree:
    data = np.load(path)
    levels = []
    while f"level{len(levels)}" in data:
        levels.append(data[f"level{len(levels)}"])
    return tree_from_arrays(levels, data["proj"], data["thresholds"], device)


def quantize(tree: VocabTree, desc: torch.Tensor) -> torch.Tensor:
    """(..., D) descriptors -> (...,) int64 leaf word ids. Per level the
    distance to a child is |c|^2 - 2 x.c, the first child wins ties."""
    lead = desc.shape[:-1]
    x = desc.reshape(-1, desc.shape[-1])
    B = tree.branching
    step = max(1, _CHUNK_ELEMS // tree.num_words)
    out = []
    for s in range(0, x.shape[0], step):
        xs = x[s:s + step]
        node = torch.zeros(xs.shape[0], dtype=torch.long, device=x.device)
        for level in tree.levels:
            flat = level.to(xs.dtype).reshape(-1, level.shape[-1])
            d2 = torch.sum(flat ** 2, -1)[None, :] - 2.0 * (xs @ flat.T)
            cols = node[:, None] * B + torch.arange(B, device=x.device)
            node = node * B + torch.argmin(torch.gather(d2, 1, cols), dim=1)
        out.append(node)
    return torch.cat(out).reshape(lead) if out else \
        torch.zeros(lead, dtype=torch.long, device=x.device)


def hamming_signatures(tree: VocabTree, desc: torch.Tensor,
                       words: torch.Tensor) -> torch.Tensor:
    """(..., bits) uint8 in {0, 1}: the projected descriptor against its
    word's thresholds."""
    z = desc @ tree.proj.to(desc.dtype)
    return (z > tree.thresholds[words]).to(torch.uint8)


def build_vocab_tree(train_desc: np.ndarray,
                     opts: VocabTreeOptions = VocabTreeOptions(),
                     seed: int = 0, device=None) -> VocabTree:
    """Train the tree level by level: each node's descriptors split by
    k-means on the device (a node with at most B keeps them, repeated to
    fill B), then a Gaussian projection and each word's median
    thresholds (the global median for words with fewer than 4)."""
    dev = devmod.resolve(device)
    B = opts.branching
    rng = np.random.default_rng(seed)
    gen = rt.generator(seed)
    train = np.asarray(train_desc, np.float32)
    train_t = torch.as_tensor(train, device=dev)

    levels = []
    assign = np.zeros(len(train), np.int64)            # node id at level l
    for lvl in range(opts.depth):
        num_nodes = B ** lvl
        cents_l = np.zeros((num_nodes, B, train.shape[1]), np.float32)
        for node in range(num_nodes):
            sel = train[assign == node]
            if len(sel) == 0:
                continue
            if len(sel) <= B:
                cents_l[node, :len(sel)] = sel
                cents_l[node, len(sel):] = sel[
                    rng.integers(0, len(sel), B - len(sel))]
            else:
                cents_l[node] = rt.kmeans_fit(
                    torch.as_tensor(sel, device=dev), gen, B,
                    opts.kmeans_iters).cpu().numpy()
        levels.append(torch.as_tensor(cents_l, device=dev))
        assign = quantize(VocabTree(tuple(levels), None, None),
                          train_t).cpu().numpy()

    bits = opts.embedding_bits
    proj = rng.standard_normal((train.shape[1], bits)).astype(np.float32)
    z = train @ proj
    num_words = B ** opts.depth
    thresholds = np.zeros((num_words, bits), np.float32)
    thresholds[:] = np.median(z, axis=0)
    for w in range(num_words):
        sel = z[assign == w]
        if len(sel) >= 4:
            thresholds[w] = np.median(sel, axis=0)
    return VocabTree(tuple(levels), torch.as_tensor(proj, device=dev),
                     torch.as_tensor(thresholds, device=dev))


class VisualIndex:
    """Inverted index over a VocabTree.

    `add` quantises an image's descriptors into words and keeps (word,
    signature, keypoint geometry) of its masked-in slots; `query` ranks
    every other indexed image by TF-IDF cosine and can re-rank the top
    ones by Hamming-embedding votes.
    """

    def __init__(self, tree: VocabTree,
                 opts: VocabTreeOptions = VocabTreeOptions()):
        self.tree = tree
        self.opts = opts
        self.device = tree.proj.device
        self.image_ids: list = []
        self._words: dict = {}        # image_id -> (K,) int32
        self._sigs: dict = {}         # image_id -> (K, bits) uint8
        self._geom: dict = {}         # image_id -> (K, 4) x y scale ori
        self._tf: dict = {}           # image_id -> (num_words,) float32
        self._idf_cache = None
        self._dev_cache: dict = {}    # image_id -> (words, sigs) on device

    def add(self, image_id: int, descriptors: np.ndarray,
            keypoints: np.ndarray | None = None,
            mask: np.ndarray | None = None) -> None:
        desc = torch.as_tensor(np.asarray(descriptors, np.float32),
                               device=self.device)
        mask = np.ones(len(descriptors), bool) if mask is None \
            else np.asarray(mask, bool)
        words_t = quantize(self.tree, desc)
        sigs = hamming_signatures(self.tree, desc, words_t).cpu().numpy()
        words = words_t.cpu().numpy().astype(np.int32)[mask]
        sigs = sigs[mask]
        self.image_ids.append(image_id)
        self._words[image_id] = words
        self._sigs[image_id] = sigs
        if keypoints is not None:
            self._geom[image_id] = np.asarray(keypoints, np.float32)[mask]
        self._tf[image_id] = np.bincount(
            words, minlength=self.tree.num_words).astype(np.float32)
        self._idf_cache = None
        self._dev_cache.pop(image_id, None)

    def _idf(self) -> np.ndarray:
        if self._idf_cache is None:
            n = max(len(self.image_ids), 1)
            df = np.zeros(self.tree.num_words, np.float32)
            for i in self.image_ids:
                df += self._tf[i] > 0
            self._idf_cache = np.log(n / np.maximum(df, 1.0)).astype(
                np.float32)
        return self._idf_cache

    def query(self, image_id: int, num_images: int = 100,
              rerank: int = 0) -> list:
        """Top-num_images (other_id, score) by TF-IDF cosine; with
        `rerank`, the top `rerank` re-scored by Hamming votes."""
        idf = self._idf()
        ids = [i for i in self.image_ids if i != image_id]
        if not ids:
            return []
        q = self._tf[image_id] * idf
        q /= max(np.linalg.norm(q), 1e-9)
        db = np.stack([self._tf[i] * idf for i in ids])
        db /= np.maximum(np.linalg.norm(db, axis=1, keepdims=True), 1e-9)
        scores = db @ q
        order = np.argsort(-scores)[:max(num_images, rerank)]
        out = [(ids[int(a)], float(scores[int(a)])) for a in order]
        if rerank > 0:
            rescored = [(i, self._hamming_score(image_id, i))
                        for i, _ in out[:rerank]]
            rescored.sort(key=lambda t: -t[1])
            out = rescored + out[rerank:]
        return out[:num_images]

    def _on_device(self, i):
        if i not in self._dev_cache:
            self._dev_cache[i] = (
                torch.as_tensor(self._words[i], dtype=torch.long,
                                device=self.device),
                torch.as_tensor(self._sigs[i], dtype=torch.float32,
                                device=self.device))
        return self._dev_cache[i]

    def _votes(self, qid: int, dbid: int) -> torch.Tensor:
        """(Kq, Kd) bool: slot pairs of one word within the Hamming
        threshold. Distances of {0, 1} signatures as |a| + |b| - 2 a.b
        (exact small integers in f32)."""
        (qw, qs), (dw, ds) = self._on_device(qid), self._on_device(dbid)
        hd = qs.sum(1)[:, None] + ds.sum(1)[None, :] - 2.0 * (qs @ ds.T)
        return (qw[:, None] == dw[None, :]) & \
            (hd <= self.opts.hamming_threshold)

    def _hamming_score(self, qid: int, dbid: int) -> float:
        """idf-weighted count of the slot pairs that share a word within
        the Hamming threshold, over sqrt(Kq Kd); the per-word counts come
        from the device, the sum runs over the shared words in ascending
        order as in the reference."""
        qw, dw = self._words[qid], self._words[dbid]
        idf = self._idf()
        per_row = self._votes(qid, dbid).sum(1).cpu().numpy()
        counts = np.bincount(qw, weights=per_row,
                             minlength=self.tree.num_words)
        score = 0.0
        for w in np.intersect1d(qw, dw):
            score += float(idf[w]) * float(counts[w])
        denom = np.sqrt(max(len(qw), 1) * max(len(dw), 1))
        return score / denom

    def match_words(self, qid: int, dbid: int) -> np.ndarray:
        """(M, 2) candidate correspondences (indices into the two images'
        kept slots) that share a word within the Hamming threshold,
        ordered by word, then query slot, then database slot."""
        ii, jj = (a.cpu().numpy() for a in
                  torch.nonzero(self._votes(qid, dbid), as_tuple=True))
        order = np.lexsort((jj, ii, self._words[qid][ii]))
        return np.stack([ii[order], jj[order]], 1).astype(np.int64) \
            .reshape(-1, 2)


def vote_and_verify(kp1: np.ndarray, kp2: np.ndarray,
                    matches: np.ndarray,
                    num_bins_xy: int = 16, num_bins_scale: int = 8,
                    num_bins_ori: int = 8,
                    image_extent: float = 2048.0) -> tuple:
    """Hough voting over 4-DoF similarity transforms, then an affine fit
    to the densest bin's correspondences.

    kp*: (K, 4) x, y, scale, orientation; matches: (M, 2) indices.
    Returns (score, inlier mask over matches)."""
    if len(matches) == 0:
        return 0.0, np.zeros(0, bool)
    a = kp1[matches[:, 0]]
    b = kp2[matches[:, 1]]
    ds = np.log2(np.maximum(b[:, 2], 1e-6) / np.maximum(a[:, 2], 1e-6))
    do = (b[:, 3] - a[:, 3] + np.pi) % (2 * np.pi) - np.pi
    s = 2.0 ** ds
    c, si = np.cos(do), np.sin(do)
    tx = b[:, 0] - s * (c * a[:, 0] - si * a[:, 1])
    ty = b[:, 1] - s * (si * a[:, 0] + c * a[:, 1])

    bs = np.clip(((ds + 4.0) / 8.0 * num_bins_scale).astype(int),
                 0, num_bins_scale - 1)
    bo = np.clip(((do + np.pi) / (2 * np.pi) * num_bins_ori).astype(int),
                 0, num_bins_ori - 1)
    bx = np.clip(((tx / image_extent + 1.0) / 2.0 * num_bins_xy).astype(int),
                 0, num_bins_xy - 1)
    by = np.clip(((ty / image_extent + 1.0) / 2.0 * num_bins_xy).astype(int),
                 0, num_bins_xy - 1)
    flat = ((bs * num_bins_ori + bo) * num_bins_xy + bx) * num_bins_xy + by
    best = np.argmax(np.bincount(flat))
    sel = flat == best
    if sel.sum() < 3:
        return float(sel.sum()), sel

    A = np.zeros((2 * sel.sum(), 6))
    rhs = np.zeros(2 * sel.sum())
    pa, pb = a[sel], b[sel]
    A[0::2, 0] = pa[:, 0]
    A[0::2, 1] = pa[:, 1]
    A[0::2, 4] = 1.0
    A[1::2, 2] = pa[:, 0]
    A[1::2, 3] = pa[:, 1]
    A[1::2, 5] = 1.0
    rhs[0::2] = pb[:, 0]
    rhs[1::2] = pb[:, 1]
    sol, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    M = np.array([[sol[0], sol[1], sol[4]], [sol[2], sol[3], sol[5]]])
    pred = (M[:, :2] @ a[:, :2].T).T + M[:, 2]
    err = np.linalg.norm(pred - b[:, :2], axis=1)
    inl = err < 0.01 * image_extent
    return float(inl.sum()), inl
