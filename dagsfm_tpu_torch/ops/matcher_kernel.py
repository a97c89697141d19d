"""Fused ratio-test + mutual-check matcher: CUDA kernel and plain version.

Replaces `_fused_matcher_kernel` (dagsfm_tpu/ops/pallas_matcher.py, entry
`pallas_match_j_batch`). The kernel is `csrc/fused_matcher.cu`, compiled
with nvcc for sm_90a into a shared library with a plain C interface and
loaded with ctypes; see the .cu file and `csrc/matcher_tiles.cuh` for the
design and its bound.

`fused_match_j` launches the kernel for CUDA tensors and runs the plain
PyTorch version (`fused_match_j_reference`) only for CPU tensors; for a
CUDA tensor it launches or raises, never falls back.
`match_pair_batch_fused` is the counterpart of `pallas_match_pair_batch`:
the same kernel, with (B, K, 2) matches out.

The kernel multiplies on the bf16 tensor cores, which add the 128
products in their own order, so its scores may differ from the plain
version's by a few f32 ulps and its j from the plain j at borderline rows
only (`borderline_rows`, with top2_matcher.EPS): rows whose decision can
change when every score moves by at most EPS.
"""

from __future__ import annotations

import ctypes

import torch

from dagsfm_tpu_torch.ops import cuda_build
from dagsfm_tpu_torch.ops.top2_matcher import EPS, score_gap

launches = 0          # kernel launches (one per fused_match_j on a GPU)


def load_library():
    """Build (when the source hash changed) and load the kernel library,
    and verification's nullspace kernel beside it: both nvcc at once."""
    lib = cuda_build.load("fused_matcher",
                          "minimal_nullspace")["fused_matcher"]
    cuda_build.set_signature(lib.fused_match_j_launch, 4,
                             [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_float, ctypes.c_int], 6)
    return lib


def masked_scores(d1, d2, m1, m2) -> torch.Tensor:
    """The plain version's (B, K, K) scores: bf16-rounded inputs, f32
    product, -inf where m1 or m2 is unset."""
    a = d1.to(torch.bfloat16).float()
    b = d2.to(torch.bfloat16).float()
    sim = a @ b.transpose(-1, -2)                             # (B, K, K)
    return torch.where(m1[:, :, None] & m2[:, None, :], sim, -torch.inf)


def _top2(sim):
    best, bidx = torch.max(sim, dim=-1)
    cols = torch.arange(sim.shape[-1], device=sim.device)
    second = torch.where(cols == bidx[..., None], -torch.inf, sim).amax(-1)
    return best, second, bidx


def _passes(best, second, max_ratio, max_distance):
    """Ratio and distance tests on (best, second) scores."""
    d_best = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    d_second = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=1e-12))
    return (d_best < max_ratio * d_second) & (d_best < max_distance)


def match_j_of_scores(sim, m1, max_ratio: float = 0.8,
                      max_distance: float = 0.7,
                      cross_check: bool = True) -> torch.Tensor:
    """j (B, K) int32 of (B, K, K) masked scores: max / masked max /
    first-index argmax, ratio and distance tests, mutual check."""
    best, second, bidx = _top2(sim)
    ok = _passes(best, second, max_ratio, max_distance) & m1
    if cross_check:
        rev = torch.argmax(sim, dim=1)                        # (B, K)
        rows = torch.arange(sim.shape[1], device=sim.device)
        ok = ok & (torch.gather(rev, 1, bidx) == rows)
    return torch.where(ok, bidx, -1).to(torch.int32)


def fused_match_j_reference(d1, d2, m1, m2, max_ratio: float = 0.8,
                            max_distance: float = 0.7,
                            cross_check: bool = True) -> torch.Tensor:
    """Plain PyTorch version. d1, d2 (B, K, D); m1, m2 (B, K) bool.
    Returns j (B, K) int32, -1 = no match."""
    return match_j_of_scores(masked_scores(d1, d2, m1, m2), m1, max_ratio,
                             max_distance, cross_check)


def borderline_of_scores(sim, max_ratio: float = 0.8,
                         max_distance: float = 0.7, cross_check: bool = True,
                         eps: float = EPS) -> torch.Tensor:
    """(B, K) bool: the rows whose j may change when every one of the
    (B, K, K) masked scores moves by at most eps. A row is borderline if
    its top-2 gap is under 2 eps, if its ratio or distance test gives
    another answer with best and second each moved by eps (the tests are
    monotone, so the two extremes decide), or, with the cross-check, if
    the column its argbest points at has a top-2 gap under 2 eps."""
    best, second, bidx = _top2(sim)
    flag = (best - second) < 2 * eps        # the row's top-2 gap (nan: all -inf)
    flag |= (_passes(best + eps, second - eps, max_ratio, max_distance)
             != _passes(best - eps, second + eps, max_ratio, max_distance))
    if cross_check:
        col = score_gap(sim, -2) < 2 * eps                    # (B, K)
        flag |= torch.gather(col, 1, bidx)
    return flag


def borderline_rows(d1, d2, m1, m2, max_ratio: float = 0.8,
                    max_distance: float = 0.7, cross_check: bool = True,
                    eps: float = EPS) -> torch.Tensor:
    """Borderline rows of these inputs (`borderline_of_scores` on the
    plain version's scores): where the kernel's j may differ from the
    plain version's under the borderline rule."""
    return borderline_of_scores(masked_scores(d1, d2, m1, m2), max_ratio,
                                max_distance, cross_check, eps)


def fused_match_j(d1, d2, m1, m2, max_ratio: float = 0.8,
                  max_distance: float = 0.7,
                  cross_check: bool = True) -> torch.Tensor:
    """Fused matcher: (B, K) int32 j per row of d1, -1 = no match.

    CUDA tensors: d1, d2 (B, K, 128) bf16 contiguous, m1, m2 (B, K) bool
    contiguous, all on one device; anything else raises. CPU tensors run
    the plain version."""
    global launches
    if d1.device.type == "cpu":
        return fused_match_j_reference(d1, d2, m1, m2, max_ratio,
                                       max_distance, cross_check)
    if d1.device.type != "cuda":
        raise ValueError(f"fused_match_j: unsupported device {d1.device}")
    if d1.dim() != 3:
        raise ValueError("fused_match_j: d1 must be (B, K, 128)")
    B, K, _ = d1.shape
    cuda_build.check_tensors("fused_match_j", (
        ("d1", d1, torch.bfloat16, (B, K, 128)),
        ("d2", d2, torch.bfloat16, (B, K, 128)),
        ("m1", m1, torch.bool, (B, K)),
        ("m2", m2, torch.bool, (B, K))), d1.device)
    lib = load_library()
    dev = d1.device
    best = torch.empty((B, K), dtype=torch.float32, device=dev)
    second = torch.empty((B, K), dtype=torch.float32, device=dev)
    idx = torch.empty((B, K), dtype=torch.int32, device=dev)
    col_key = torch.zeros((B, K) if cross_check else (1,), dtype=torch.int64,
                          device=dev)
    j = torch.empty((B, K), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_match_j_launch(
        d1.data_ptr(), d2.data_ptr(), m1.data_ptr(), m2.data_ptr(), B, K,
        float(max_ratio), float(max_distance), int(bool(cross_check)),
        best.data_ptr(), second.data_ptr(), idx.data_ptr(),
        col_key.data_ptr(), j.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_match_j: CUDA launch error {err}")
    launches += 1
    return j


def match_pair_batch_fused(d1, d2, m1, m2, max_ratio: float = 0.8,
                           max_distance: float = 0.7,
                           cross_check: bool = True):
    """Batched matcher on the fused kernel (`pallas_match_pair_batch`):
    (matches (B, K, 2) int32 with -1 pads, num_matches (B,))."""
    j = fused_match_j(d1, d2, m1, m2, max_ratio, max_distance, cross_check)
    ok = j >= 0
    k_idx = torch.arange(j.shape[1], device=j.device).expand(j.shape)
    matches = torch.stack([torch.where(ok, k_idx, -1), j.long()], dim=-1)
    return matches.to(torch.int32), ok.sum(1)
