"""Sim(3) / SE(3) alignment: closed-form Umeyama.

Port of `umeyama` and `umeyama_np` from dagsfm_tpu/ops/umeyama.py.
Convention: y ~ s * R @ x + t.
"""

from __future__ import annotations

import numpy as np
import torch


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
