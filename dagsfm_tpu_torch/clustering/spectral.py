"""Spectral graph clustering: Laplacian eigenmaps + k-means on the device.

Port of dagsfm_tpu/clustering/spectral.py: the dense normalized
Laplacian, its eigenvectors, row normalisation (Ng-Jordan-Weiss), a
farthest-point start from one node, and 50 Lloyd steps. The reference
draws the start node with `jax.random.randint`, which torch cannot
replay: `spectral_cluster` takes it as `start`, or draws it from a
`torch.Generator` seeded with `seed`. Eigenvector signs and the basis of
a repeated eigenvalue differ between libraries; row norms and k-means
distances do not see either, so the labels agree up to a permutation.
"""

from __future__ import annotations

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod


def _draw_start(num_nodes: int, seed: int) -> int:
    """The first centroid's node, drawn from a generator seeded with seed."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    return int(torch.randint(0, num_nodes, (), generator=gen))


def _spectral(W: torch.Tensor, num_clusters: int, start: int,
              kmeans_iters: int = 50) -> torch.Tensor:
    N, k = W.shape[0], num_clusters
    deg = W.sum(1)
    dinv = 1.0 / torch.sqrt(torch.clamp(deg, min=1e-12))
    L = torch.eye(N, dtype=W.dtype, device=W.device) \
        - W * dinv[:, None] * dinv[None, :]
    _, evecs = torch.linalg.eigh(L)
    emb = evecs[:, :k]
    emb = emb / torch.clamp(torch.linalg.norm(emb, dim=1, keepdim=True),
                            min=1e-12)

    cents = torch.zeros((k, emb.shape[1]), dtype=W.dtype, device=W.device)
    cents[0] = emb[start]
    d = torch.sum((emb - emb[start]) ** 2, dim=1)
    for j in range(1, k):
        nxt = torch.argmax(d)
        cents[j] = emb[nxt]
        d = torch.minimum(d, torch.sum((emb - emb[nxt]) ** 2, dim=1))

    for _ in range(kmeans_iters):
        d2 = torch.sum((emb[:, None, :] - cents[None]) ** 2, dim=-1)
        onehot = torch.nn.functional.one_hot(torch.argmin(d2, dim=1),
                                             k).to(W.dtype)
        filled = onehot.sum(0)
        new_c = (onehot.T @ emb) / torch.clamp(filled, min=1e-9)[:, None]
        cents = torch.where((filled > 0)[:, None], new_c, cents)
    d2 = torch.sum((emb[:, None, :] - cents[None]) ** 2, dim=-1)
    return torch.argmin(d2, dim=1)


def spectral_cluster(edges: np.ndarray, weights: np.ndarray,
                     num_nodes: int, num_clusters: int, seed: int = 0,
                     start: int | None = None, device=None) -> np.ndarray:
    """Cluster labels (num_nodes,) int32 of an undirected weighted graph,
    computed on `device` (the GPU unless told "cpu"). `start` is the
    node of the first centroid (default: drawn with `seed`)."""
    dev = devmod.resolve(device)
    if num_clusters <= 1 or num_nodes <= num_clusters:
        return np.zeros(num_nodes, np.int32) if num_clusters <= 1 \
            else np.arange(num_nodes, dtype=np.int32) % num_clusters
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    w = np.asarray(weights, np.float64)
    W = np.zeros((num_nodes, num_nodes))
    np.add.at(W, (e[:, 0], e[:, 1]), w)     # in edge order, no atomics
    np.add.at(W, (e[:, 1], e[:, 0]), w)
    if start is None:
        start = _draw_start(num_nodes, seed)
    labels = _spectral(devmod.as_tensor(W, dev), num_clusters, int(start))
    return labels.cpu().numpy().astype(np.int32)


def normalized_cut_value(edges, weights, labels) -> float:
    """The NCut objective of a labelling."""
    labels = np.asarray(labels)
    w = np.asarray(weights, float)
    cut = 0.0
    vol = {}
    for (i, j), wt in zip(np.asarray(edges), w):
        vol[labels[i]] = vol.get(labels[i], 0.0) + wt
        vol[labels[j]] = vol.get(labels[j], 0.0) + wt
        if labels[i] != labels[j]:
            cut += wt
    out = 0.0
    for c, v in vol.items():
        cut_c = sum(wt for (i, j), wt in zip(np.asarray(edges), w)
                    if (labels[i] == c) != (labels[j] == c))
        out += cut_c / max(v, 1e-12)
    return out
