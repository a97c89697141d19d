"""Plain reference of descriptor matching (COLMAP's SiftMatchingOptions:
ratio test, distance test, mutual check), and the rows where rounding may
decide.

Scores are the float32 products of the descriptors as given (bf16 in the
benchmark), with TF32 off. `dtype` rounds the descriptors first: the
control passes `torch.float8_e4m3fn`, the nearest precision below bf16.

A kernel that adds the 128 products in another order than this product
may move every score by a few float32 ulps. EPS bounds that move: the
scores are products of unit-norm descriptors, so their absolute terms add
to at most about 1, and each of the 128 additions may be off by one ulp
at 1. A row is borderline when a move of EPS in every score could change
its answer; only the other rows are held to equality.
"""

from __future__ import annotations

import torch

EPS = 128 * 2.0 ** -23


def _scores(d1, d2, m1, m2, dtype):
    a = d1.to(dtype).float()
    b = d2.to(dtype).float()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sim = a @ b.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.where(m1[:, None] & m2[None, :], sim, -torch.inf)


def _top2(sim, dim):
    best, arg = torch.max(sim, dim=dim)
    pos = torch.arange(sim.shape[dim], device=sim.device)
    if dim == 1:
        second = torch.where(pos[None, :] == arg[:, None], -torch.inf,
                             sim).amax(1)
    else:
        second = torch.where(pos[:, None] == arg[None, :], -torch.inf,
                             sim).amax(0)
    return best, second, arg


def _tests(best, second, max_ratio, max_distance):
    d_best = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    d_second = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=1e-12))
    return (d_best < max_ratio * d_second) & (d_best < max_distance)


def match_rows(d1, d2, m1, m2, max_ratio: float = 0.8,
               max_distance: float = 0.7, cross_check: bool = True,
               dtype=torch.bfloat16):
    """One pair: (j (K,) int64, -1 for no match; borderline (K,) bool).
    d1, d2 (K, 128); m1, m2 (K,) bool."""
    sim = _scores(d1, d2, m1, m2, dtype)
    best, second, arg = _top2(sim, 1)
    ok = _tests(best, second, max_ratio, max_distance) & m1
    flag = (best - second) < 2 * EPS
    flag |= (_tests(best + EPS, second - EPS, max_ratio, max_distance)
             != _tests(best - EPS, second + EPS, max_ratio, max_distance))
    if cross_check:
        cbest, csecond, carg = _top2(sim, 0)
        ok &= carg[arg] == torch.arange(sim.shape[0], device=sim.device)
        flag |= ((cbest - csecond) < 2 * EPS)[arg]
    flag &= m1
    return torch.where(ok, arg, -1), flag


def truncate(j: torch.Tensor, max_num_matches: int) -> torch.Tensor:
    """(M, 2) rows and columns of the first max_num_matches matched rows."""
    rows = torch.nonzero(j >= 0)[:max_num_matches, 0]
    return torch.stack([rows, j[rows]], -1)
