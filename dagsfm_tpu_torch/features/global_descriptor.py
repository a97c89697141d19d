"""Global image descriptors for similarity-graph pair selection.

Port of dagsfm_tpu/features/global_descriptor.py, the role of the
reference's global-descriptor (MirrorSimilarityGraph) kNN graph without
its CNN weights:

  * the Gabor embedding of raw images (the fallback when no local
    features exist): resize to 128 x 128 (`sift.resize_linear`, which
    reproduces `jax.image.resize` "linear"), mean removed, a 15 x 15
    SAME convolution with 24 Gabor filters (`F.conv2d`, a library call:
    it is an XLA convolution in the JAX package, not a Pallas kernel),
    |.|, 4 x 4 cell means, L2 normalisation;
  * VLAD over local SIFT descriptors (what the `global` pair mode uses
    when descriptors exist): a k-means codebook (`retrieval.kmeans_fit`),
    each descriptor's residual to its nearest centroid summed per
    centroid, signed square root, L2 normalisation.

Both run on the device; `global_similarity_pairs` ranks on the host in
numpy as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.features import retrieval as rt
from dagsfm_tpu_torch.features.sift import resize_linear

GRID = 4            # pooling cells per side
SIZE = 128          # working resolution
_ORIENTATIONS = 8
_SCALES = (2.0, 4.0, 8.0)
_KSIZE = 15


def _gabor_bank() -> np.ndarray:
    """(F, 1, K, K) real Gabor kernels, F = orientations x scales."""
    ax = np.arange(_KSIZE) - _KSIZE // 2
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    kernels = []
    for lam in _SCALES:
        sigma = 0.6 * lam
        for o in range(_ORIENTATIONS):
            th = np.pi * o / _ORIENTATIONS
            xr = xx * np.cos(th) + yy * np.sin(th)
            yr = -xx * np.sin(th) + yy * np.cos(th)
            g = np.exp(-(xr ** 2 + yr ** 2) / (2 * sigma ** 2)) * \
                np.cos(2 * np.pi * xr / lam)
            g -= g.mean()
            n = np.linalg.norm(g)
            kernels.append(g / max(n, 1e-9))
    return np.stack(kernels)[:, None].astype(np.float32)


_BANK = _gabor_bank()
DESC_DIM = _BANK.shape[0] * GRID * GRID


def embed_batch(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 images -> (B, DESC_DIM) L2-normalised descriptors,
    on the images' device."""
    B = images.shape[0]
    x = resize_linear(images.to(torch.float32), SIZE, SIZE)
    x = x - torch.mean(x, dim=(1, 2), keepdim=True)
    resp = torch.nn.functional.conv2d(
        x[:, None], torch.as_tensor(_BANK, device=x.device),
        padding=_KSIZE // 2)                              # (B, F, S, S)
    cell = SIZE // GRID
    pooled = torch.abs(resp).reshape(B, -1, GRID, cell, GRID, cell) \
        .mean((3, 5))
    v = pooled.reshape(B, -1)
    return v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True),
                           min=1e-9)


def global_descriptors(images: dict, batch_size: int = 16,
                       device=None) -> dict:
    """image_id -> (DESC_DIM,) float32 Gabor descriptor; images of one
    size within each batch of `batch_size` ids embed together."""
    dev = devmod.resolve(device)
    ids = sorted(images)
    out = {}
    for s in range(0, len(ids), batch_size):
        by_shape: dict = {}
        for i in ids[s: s + batch_size]:
            by_shape.setdefault(np.asarray(images[i]).shape, []).append(i)
        for members in by_shape.values():
            batch = torch.as_tensor(np.stack(
                [np.asarray(images[i], np.float32) for i in members]),
                device=dev)
            d = embed_batch(batch).cpu().numpy()
            for k, i in enumerate(members):
                out[i] = d[k]
    return out


def _vlad_one(desc: torch.Tensor, mask: torch.Tensor,
              centroids: torch.Tensor, k: int) -> torch.Tensor:
    """(N, D) descriptors, (N,) mask, (k, D) centroids -> (k * D,) VLAD.
    Masked slots are zeroed first (a masked slot may hold NaN) and weigh
    0. The (N, k, D) residuals are one image's: 67 MB at 8,192 slots."""
    desc = torch.where(mask[:, None], desc, torch.zeros_like(desc))
    assign = torch.argmax(desc @ centroids.T, dim=1)
    onehot = torch.nn.functional.one_hot(assign, k).to(desc.dtype) \
        * mask[:, None].to(desc.dtype)
    resid = desc[:, None, :] - centroids[None, :, :]
    v = torch.einsum("nk,nkd->kd", onehot, resid).reshape(-1)
    v = torch.sign(v) * torch.sqrt(torch.abs(v))
    return v / torch.clamp(torch.linalg.norm(v), min=1e-9)


def vlad_descriptors(descriptors: dict, masks: dict, k: int = 16,
                     seed: int = 0, train_cap: int = 20000,
                     device=None) -> dict:
    """image_id -> VLAD embedding of its masked-in descriptors, over a
    codebook fit to (at most train_cap of) the scene's own descriptors."""
    dev = devmod.resolve(device)
    ids = sorted(descriptors)
    train = np.concatenate([np.asarray(descriptors[i])[np.asarray(masks[i])]
                            for i in ids])
    rng = np.random.default_rng(seed)
    if len(train) > train_cap:
        train = train[rng.choice(len(train), train_cap, replace=False)]
    cents = rt.kmeans_fit(torch.as_tensor(train, device=dev),
                          rt.generator(seed), k)
    return {i: _vlad_one(torch.as_tensor(np.asarray(descriptors[i]),
                                         dtype=cents.dtype, device=dev),
                         torch.as_tensor(np.array(masks[i], bool),
                                         device=dev),
                         cents, k).cpu().numpy()
            for i in ids}


def global_similarity_pairs(descriptors: dict, num_neighbors: int = 10,
                            min_score: float = 0.0) -> list:
    """Each image's top-num_neighbors cosine neighbours with score >=
    min_score: [(i, j, score)], i < j, deduplicated, sorted by pair."""
    ids = sorted(descriptors)
    if len(ids) < 2:
        return []
    D = np.stack([descriptors[i] for i in ids])
    S = D @ D.T
    np.fill_diagonal(S, -np.inf)
    pairs = {}
    k = min(num_neighbors, len(ids) - 1)
    for a, i in enumerate(ids):
        for b in np.argpartition(-S[a], k - 1)[:k]:
            j = ids[int(b)]
            if S[a, b] < min_score:
                continue
            key = (i, j) if i < j else (j, i)
            pairs[key] = max(pairs.get(key, -np.inf), float(S[a, b]))
    return [(i, j, s) for (i, j), s in sorted(pairs.items())]
