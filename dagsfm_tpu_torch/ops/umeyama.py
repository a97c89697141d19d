"""Sim(3) / SE(3) alignment: closed-form Umeyama and its RANSAC.

Port of dagsfm_tpu/ops/umeyama.py. Convention: y ~ s * R @ x + t. The
reference draws RANSAC's 3-point samples with `jax.random` inside
`ransac_umeyama`; torch cannot replay that stream, so sampling is split
out (`sample_triplets`) and `ransac_umeyama` takes the indices.
"""

from __future__ import annotations

import numpy as np
import torch

from dagsfm_tpu_torch.ops import ransac as rnsc


def umeyama(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor | None = None,
            with_scale: bool = True):
    """Weighted Umeyama over leading batch dims.

    x, y (..., N, 3); w (..., N) nonnegative weights or None.
    Returns (s (...), R (..., 3, 3), t (..., 3)).
    """
    if w is None:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    mx = torch.sum(wn[..., None] * x, dim=-2)
    my = torch.sum(wn[..., None] * y, dim=-2)
    xc = x - mx[..., None, :]
    yc = y - my[..., None, :]
    S = (yc * wn[..., None]).transpose(-1, -2) @ xc
    U, D, Vt = torch.linalg.svd(S)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    sgn = torch.where(det < 0, -1.0, 1.0).to(x.dtype)
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], -1)
    R = (U * diag[..., None, :]) @ Vt
    var_x = torch.sum(wn * torch.sum(xc * xc, dim=-1), dim=-1)
    if with_scale:
        s = torch.sum(D * diag, -1) / torch.clamp(var_x, min=1e-12)
    else:
        s = torch.ones_like(var_x)
    t = my - s[..., None] * (R @ mx[..., None])[..., 0]
    return s, R, t


def umeyama_np(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """NumPy host version (evaluation code)."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    S = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(S)
    diag = np.ones(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        diag[2] = -1.0
    R = (U * diag) @ Vt
    var_x = (xc ** 2).sum() / len(x)
    s = float((D * diag).sum() / max(var_x, 1e-12)) if with_scale else 1.0
    t = my - s * R @ mx
    return s, R, t


def transform_points(s, R, t, x):
    """s R x + t for points x (..., N, 3) under (...) Sim(3)s."""
    s = torch.as_tensor(s, dtype=x.dtype, device=x.device)
    return (s[..., None, None] * x) @ R.transpose(-1, -2) + t[..., None, :]


def alignment_errors(s, R, t, x, y):
    return torch.linalg.norm(transform_points(s, R, t, x) - y, dim=-1)


def sample_triplets(generator: torch.Generator, mask: torch.Tensor,
                    num_iters: int) -> torch.Tensor:
    """(num_iters, 3) uniform 3-subsets of the valid rows of mask (N,)."""
    return rnsc.sample_indices(generator, mask[None], num_iters, 3)[0]


def ransac_umeyama(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                   sample_idx: torch.Tensor, threshold: float):
    """RANSAC Sim(3) y ≈ s R x + t with every hypothesis in one batch.

    x, y (N, 3); mask (N,) validity; sample_idx (H, 3) rows of x per
    hypothesis (`sample_triplets`, or the reference's Gumbel draws). The
    hypothesis with the most inliers wins (the first on ties); with >= 3
    inliers the model is refit on them by weighted Umeyama, then the
    inliers are counted again. Returns (s, R, t, inlier_mask,
    num_inliers)."""
    ss, Rs, ts = umeyama(x[sample_idx], y[sample_idx])
    inl = (alignment_errors(ss, Rs, ts, x, y) < threshold) & mask
    best = torch.argmax(inl.sum(-1))
    s, R, t = ss[best], Rs[best], ts[best]
    inliers = (alignment_errors(s, R, t, x, y) < threshold) & mask
    enough = inliers.sum() >= 3
    s2, R2, t2 = umeyama(x, y, w=inliers.to(x.dtype))
    s = torch.where(enough, s2, s)
    R = torch.where(enough, R2, R)
    t = torch.where(enough, t2, t)
    inliers = (alignment_errors(s, R, t, x, y) < threshold) & mask
    return s, R, t, inliers, inliers.sum()
