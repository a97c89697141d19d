"""Robust-estimation variants: PROSAC, LMedS, EVSAC-style weighted
sampling, exhaustive sampling, and the SPRT model test.

Port of dagsfm_tpu/ops/ransac_variants.py (Theia's ransac/ prosac,
evsac, lmed, exhaustive_ransac and optim/sprt). Each variant is a
sampling distribution and a scoring rule on one fixed-budget batched
hypothesize-and-verify, as in the JAX package:

  - PROSAC: hypothesis t samples from the quality-sorted top-n(t)
    prefix, n(t) from the Chum-Matas growth schedule (host, exact).
  - EVSAC: per-correspondence sampling weights from the match-distance
    distribution, drawn as a weighted Gumbel top-k.
  - LMedS: models scored by their median squared residual (no
    threshold); inliers from the robust scale of the best model.
  - Exhaustive: every C(N, m) minimal set.
  - SPRT: the likelihood ratio of the whole residual set against Wald's
    decision threshold.

The JAX package draws its samples with `jax.random`, which torch cannot
replay: the samplers here take a seeded `torch.Generator`, and
`robust_estimate` takes the (H, S) sample indices as `sample_idx=` (the
tests pass the JAX package's) or draws them from `generator=`.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch.ops.ransac import RansacResult, sample_indices


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def prosac_prefix_sizes(n: int, sample_size: int,
                        num_hypotheses: int) -> np.ndarray:
    """Growth schedule n(t) (Chum & Matas 2005, eq. 3): hypothesis t draws
    from the top-n(t) quality-sorted correspondences."""
    m = sample_size
    # T'_n: expected number of samples containing only top-n points
    t_n = float(num_hypotheses)
    for i in range(m):
        t_n *= (m - i) / (n - i)
    sizes = np.empty(num_hypotheses, np.int64)
    n_cur = m
    t_prime = 1.0
    for t in range(num_hypotheses):
        if t + 1 > t_prime and n_cur < n:
            t_next = t_n * (n_cur + 1) / (n_cur + 1 - m)
            t_prime += t_next - t_n
            t_n = t_next
            n_cur += 1
        sizes[t] = n_cur
    return sizes


def _gumbel(generator: torch.Generator, shape: tuple, device):
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float64).clamp_(min=1e-300)
    return -torch.log(-torch.log(u))


def prosac_sample_indices(generator: torch.Generator, num_hyps: int,
                          sample_size: int, n: int, mask: torch.Tensor,
                          quality: torch.Tensor) -> torch.Tensor:
    """(H, S) indices: hypothesis t draws S distinct entries uniformly
    from the n(t) best by `quality` (higher is better); the masked
    entries sort last, so only prefixes longer than the valid count
    reach them, as in the JAX package."""
    order = torch.argsort(-torch.where(mask, quality, -torch.inf),
                          stable=True)                       # best first
    sizes = torch.as_tensor(prosac_prefix_sizes(n, sample_size, num_hyps),
                            device=mask.device)
    g = _gumbel(generator, (num_hyps, n), mask.device)
    rank = torch.arange(n, device=mask.device)[None, :]
    g = torch.where(rank < sizes[:, None], g, -torch.inf)    # the prefix
    pos = torch.topk(g, sample_size, dim=-1).indices         # in order
    return order[pos]


def weighted_sample_indices(generator: torch.Generator, num_hyps: int,
                            sample_size: int, n: int, mask: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """(H, S) indices: S distinct valid entries with probabilities in
    proportion to `weights` (Gumbel top-k on the log-weights)."""
    logw = torch.log(torch.clamp(weights, min=1e-12))
    g = _gumbel(generator, (num_hyps, n), mask.device) + logw[None, :]
    g = torch.where(mask[None, :], g, -torch.inf)
    return torch.topk(g, sample_size, dim=-1).indices


def evsac_weights(match_distances: np.ndarray, k_smallest: int = 2) -> \
        np.ndarray:
    """Posterior inlier weights from descriptor match distances: normals
    moment-fitted to the nearest ("good") and k-th ("bad") distance
    columns, P(inlier | d) = pdf_good(d) / (pdf_good(d) + pdf_bad(d)),
    floored at 1e-6."""
    d = np.asarray(match_distances, np.float64)
    d1 = d[:, 0]
    dk = d[:, min(k_smallest, d.shape[1]) - 1]
    mu_g, sd_g = d1.mean(), max(d1.std(), 1e-9)
    mu_b, sd_b = dk.mean(), max(dk.std(), 1e-9)
    pg = np.exp(-0.5 * ((d1 - mu_g) / sd_g) ** 2) / sd_g
    pb = np.exp(-0.5 * ((d1 - mu_b) / sd_b) ** 2) / sd_b
    w = pg / np.maximum(pg + pb, 1e-12)
    return np.maximum(w, 1e-6)


def exhaustive_sample_indices(n: int, sample_size: int) -> np.ndarray:
    """Every C(n, sample_size) minimal set, in lexicographic order."""
    return np.asarray(list(itertools.combinations(range(n), sample_size)),
                      np.int32)


# ---------------------------------------------------------------------------
# SPRT
# ---------------------------------------------------------------------------

class SPRTOptions(NamedTuple):
    delta: float = 0.01      # P(inlier | bad model)
    epsilon: float = 0.1     # P(inlier | good model) lower bound
    eval_time_ratio: float = 200.0   # t_M: model eval / point eval cost
    num_models_per_sample: float = 1.0


def sprt_decision_threshold(opts: SPRTOptions) -> float:
    """Wald's decision threshold A (ComputeDecisionThreshold)."""
    c = ((1 - opts.delta) *
         math.log((1 - opts.delta) / (1 - opts.epsilon))
         + opts.delta * math.log(opts.delta / opts.epsilon))
    a0 = (opts.eval_time_ratio * c / opts.num_models_per_sample) + 1.0
    a = a0
    for _ in range(10):
        a = a0 + math.log(a)
    return a


def sprt_test(residuals_sq: torch.Tensor, mask: torch.Tensor,
              threshold: float, opts: SPRTOptions = SPRTOptions()) -> tuple:
    """The SPRT decision on the whole residual set: (accept (bool
    tensor), log_lambda). A model is rejected when its log likelihood
    ratio reaches log A; a sequential walk that runs to the end decides
    the same."""
    inl = (residuals_sq < threshold) & mask
    log_in = math.log(opts.delta / opts.epsilon)
    log_out = math.log((1 - opts.delta) / (1 - opts.epsilon))
    zero = torch.zeros_like(residuals_sq)
    log_lambda = (torch.sum(torch.where(inl, zero + log_in, zero))
                  + torch.sum(torch.where(mask & ~inl, zero + log_out,
                                          zero)))
    a = math.log(sprt_decision_threshold(opts))
    return log_lambda < a, log_lambda


# ---------------------------------------------------------------------------
# Scoring-rule RANSAC
# ---------------------------------------------------------------------------

def _lower_median(r: torch.Tensor, mask: torch.Tensor,
                  nvalid: torch.Tensor) -> torch.Tensor:
    """The ((nvalid - 1) // 2)-th smallest of each row over the valid
    entries (the invalid sorted to +inf), as the JAX package takes it."""
    rs = torch.sort(torch.where(mask, r, torch.inf), dim=-1).values
    k = ((nvalid - 1) // 2).reshape(1, 1).expand(rs.shape[0], 1)
    return torch.gather(rs, -1, k)[:, 0]


def robust_estimate(solver: Callable,
                    residual_fn: Callable,
                    data: tuple,
                    mask: torch.Tensor,
                    sample_size: int,
                    threshold: float = 0.0,
                    num_hypotheses: int = 512,
                    sampler: str = "uniform",
                    scoring: str = "msac",
                    quality: torch.Tensor | None = None,
                    refit: Callable | None = None,
                    min_inliers: int | None = None,
                    sample_idx: torch.Tensor | None = None,
                    generator: torch.Generator | None = None) -> RansacResult:
    """Batched robust estimation with a pluggable sampler and scoring.

    solver(*samples (S, ...)) -> (models (M, ...), valid (M,)) for one
    minimal sample; residual_fn(model, *data) -> (N,) squared residuals;
    refit(*data, inliers (N,)) -> model. Both are vectorised over the
    hypotheses with `torch.func.vmap`. data: (N, ...) tensors, mask (N,).
    sampler: "uniform" | "prosac" | "weighted" | "exhaustive" (prosac and
      weighted need `quality`: higher is better / the sampling weight).
    scoring: "msac" (threshold on the squared residual) | "lmeds"
      (threshold-free; inliers within 2.5 robust sigmas of the best).
    The (H, S) samples are `sample_idx` when given, else drawn by the
    sampler from `generator` (exhaustive draws nothing)."""
    n = data[0].shape[0]
    dev = mask.device
    if min_inliers is None:
        min_inliers = sample_size

    if sampler not in ("uniform", "prosac", "weighted", "exhaustive"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if sampler == "exhaustive":
        idx = torch.as_tensor(exhaustive_sample_indices(n, sample_size),
                              dtype=torch.int64, device=dev)
    elif sample_idx is not None:
        idx = torch.as_tensor(sample_idx, dtype=torch.int64, device=dev)
    else:
        if generator is None:
            raise ValueError("robust_estimate: pass sample_idx= or "
                             "generator=")
        if sampler == "uniform":
            idx = sample_indices(generator, mask[None], num_hypotheses,
                                 sample_size)[0]
        elif sampler == "prosac":
            idx = prosac_sample_indices(generator, num_hypotheses,
                                        sample_size, n, mask, quality)
        else:
            idx = weighted_sample_indices(generator, num_hypotheses,
                                          sample_size, n, mask, quality)

    models, valids = torch.func.vmap(solver)(*(d[idx] for d in data))
    flat_models = models.reshape((-1,) + models.shape[2:])
    flat_valid = valids.reshape(-1)
    thresh = torch.as_tensor(threshold, dtype=data[0].dtype, device=dev)
    nvalid = torch.clamp(torch.sum(mask), min=1)

    nd = (None,) * len(data)
    R = torch.func.vmap(residual_fn, in_dims=(0,) + nd)(flat_models, *data)
    if scoring == "lmeds":
        scores = _lower_median(R, mask[None], nvalid)
    else:
        scores = torch.sum(torch.where(mask[None], torch.minimum(R, thresh),
                                       0.0), -1)
    scores = torch.where(flat_valid, scores, torch.inf)

    best = torch.argmin(scores)
    best_model = flat_models[best]
    r = residual_fn(best_model, *data)

    if scoring == "lmeds":
        # robust scale: 1.4826 * (1 + 5 / (n - m)) * sqrt(median)
        med = _lower_median(r[None], mask[None], nvalid)[0]
        sigma = 1.4826 * (1.0 + 5.0 / torch.clamp(nvalid - sample_size,
                                                  min=1)) \
            * torch.sqrt(torch.clamp(med, min=0.0))
        eff_thresh = (2.5 * sigma) ** 2
    else:
        eff_thresh = thresh

    inliers = (r < eff_thresh) & mask
    num_inl = torch.sum(inliers)
    ok = num_inl >= min_inliers

    if refit is not None:
        re_model = refit(*data, inliers)
        rr = residual_fn(re_model, *data)
        re_inl = (rr < eff_thresh) & mask
        better = torch.sum(re_inl) >= num_inl
        best_model = torch.where(better, re_model, best_model)
        inliers = torch.where(better, re_inl, inliers)
        num_inl = torch.sum(inliers)

    final_r = residual_fn(best_model, *data)
    final_score = torch.sum(
        torch.where(mask, torch.minimum(final_r, eff_thresh), 0.0))
    return RansacResult(best_model, inliers, num_inl, final_score, ok)
