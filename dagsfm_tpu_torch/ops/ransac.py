"""Batched RANSAC / LO-RANSAC with injectable sampling.

Port of dagsfm_tpu/ops/ransac.py. The reference draws its minimal samples
with `jax.random` inside `ransac`; torch cannot replay that stream, so
sampling is split out: `ransac` takes the (B, H, S) sample indices, and
`sample_indices` draws them from a `torch.Generator` (the same Gumbel
top-k rule: uniform S-subsets of the valid entries). Solving, MSAC
scoring, the argmin and the LO refit then follow the reference exactly.

The pair batch is a written-out leading dimension B (the reference vmaps
`ransac` over pairs).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


# models x data elements scored per chunk, so the (B, models, N)
# residuals never materialise whole
_SCORE_CHUNK_ELEMS = 1 << 24


class RansacResult(NamedTuple):
    model: torch.Tensor        # (B, *model_shape)
    inliers: torch.Tensor      # (B, N) bool
    num_inliers: torch.Tensor  # (B,)
    score: torch.Tensor        # (B,) MSAC score (lower is better)
    valid: torch.Tensor        # (B,) bool: the best minimal model had at
    #                            least sample-size inliers (before the refit)


def sample_indices(generator: torch.Generator, mask: torch.Tensor,
                   num_hyps: int, sample_size: int) -> torch.Tensor:
    """(B, H, S) uniform sample indices from the valid entries of each
    (B, N) mask row (Gumbel top-k, as the reference's _sample_indices)."""
    B, N = mask.shape
    u = torch.rand((B, num_hyps, N), generator=generator, device=mask.device,
                   dtype=torch.float64).clamp_(min=1e-300)
    g = -torch.log(-torch.log(u))
    g += torch.where(mask, 0.0, -1e9)[:, None, :]
    return torch.topk(g, sample_size, dim=-1).indices


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered at idx (B, ...) along N."""
    b = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


def ransac(solver: Callable, residual_fn: Callable, data: tuple,
           mask: torch.Tensor, sample_idx: torch.Tensor, threshold,
           refit: Callable | None = None) -> RansacResult:
    """Generic batched RANSAC.

    solver(*samples (B, H, S, ...)) -> (models (B, H, M, ...), valid (B, H, M)).
    residual_fn(models (B, K, ...), *data) -> (B, K, N) squared residuals.
    refit(*data, inliers (B, N)) -> models (B, ...): the LO refit.
    data: (B, N, ...) tensors; mask (B, N); threshold on the squared
    residual, scalar or (B,).
    """
    B, N = mask.shape
    H = sample_idx.shape[-2]
    thr = torch.as_tensor(threshold, dtype=data[0].dtype, device=mask.device)
    thr = thr.expand(B) if thr.dim() == 0 else thr
    thr3 = thr[:, None, None]

    models, valids = solver(*(_take(d, sample_idx) for d in data))
    M = valids.shape[-1]
    flat = models.reshape((B, H * M) + models.shape[3:])
    flat_valid = valids.reshape(B, H * M)
    maskf = mask[:, None, :]

    step = max(1, _SCORE_CHUNK_ELEMS // max(B * N, 1))
    scores = []
    for s in range(0, H * M, step):
        r = residual_fn(flat[:, s:s + step], *data)          # (B, k, N)
        sc = torch.sum(torch.where(maskf, torch.minimum(r, thr3), 0.0), -1)
        scores.append(torch.where(flat_valid[:, s:s + step], sc, torch.inf))
    scores = torch.cat(scores, dim=1)
    best = torch.argmin(scores, dim=1)                        # (B,)
    ar = torch.arange(B, device=mask.device)
    best_model = flat[ar, best]
    r = residual_fn(best_model[:, None], *data)[:, 0]
    inliers = (r < thr[:, None]) & mask
    num_inl = inliers.sum(-1)
    valid = num_inl >= sample_idx.shape[-1]

    if refit is not None:
        re_model = refit(*data, inliers)
        rr = residual_fn(re_model[:, None], *data)[:, 0]
        re_inl = (rr < thr[:, None]) & mask
        re_score = torch.sum(
            torch.where(mask, torch.minimum(rr, thr[:, None]), 0.0), -1)
        better = (re_score <= scores[ar, best]) & (re_inl.sum(-1) >= num_inl)
        bshape = (B,) + (1,) * (best_model.dim() - 1)
        best_model = torch.where(better.reshape(bshape), re_model, best_model)
        inliers = torch.where(better[:, None], re_inl, inliers)
        num_inl = inliers.sum(-1)

    final_r = residual_fn(best_model[:, None], *data)[:, 0]
    final_score = torch.sum(
        torch.where(mask, torch.minimum(final_r, thr[:, None]), 0.0), -1)
    return RansacResult(best_model, inliers, num_inl, final_score, valid)
