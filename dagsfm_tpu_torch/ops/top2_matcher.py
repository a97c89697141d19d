"""Top-2 matchers K2, K3, K4: CUDA kernels and their plain versions.

Replaces the other Pallas kernels of the JAX package:

- K2 `_batch_matcher_kernel` (dagsfm_tpu/ops/pallas_matcher.py, entry
  `pallas_top2_batch`) -> `top2_batch`;
- K3 `_matcher_kernel` (entry `pallas_top2`) -> `top2`, and `pallas_match`
  on it -> `match_one_pair` (two launches per call);
- K4 `_mk_kernel(mode)` (tools/matcher_mfu.py, entry `run_variant`) ->
  `mfu_variant`, driven by dagsfm_tpu_torch/tools/matcher_mfu.py.

The kernels are `csrc/top2_matcher.cu` (K2 and K4 on the bf16 tensor-core
tile engine of `csrc/matcher_tiles.cuh`, K3 on f32 FMAs on the CUDA cores
over a 2-D grid; design and bound there), built by `ops/cuda_build.py`.
Each wrapper launches its kernel for CUDA tensors and counts the launch;
it runs the plain version only for CPU tensors, and for a CUDA tensor it
launches or raises, never falls back.

K3 computes each score as one chain of fused multiply-adds in order
k = 0..127, one rounding per step; its plain version does the same with
an exact emulation of the fused multiply-add (`ordered_fma_scores`,
`ops/fma.py`), so K3 and its plain version agree bit for bit. The plain
versions of K2 and K4 add the 128 products in order with the product and
the sum rounded separately (`ordered_scores`). K2 and K4 add on the
tensor cores in their own order, so their scores may differ by a few f32
ulps and an index may flip where two scores are that close: the checks
hold them to the borderline rule (`borderline`): best and second within
`EPS`, idx and rev equal except where the plain scores' top-2 gap of
that row or column is under 2 * EPS. The reference's reduction order is
XLA's; against it the scores agree to a few f32 ulps. The reference's
VMEM tile gate (`_pick_tile`, `pallas_batch_supported`) is not carried
over: K2 and K4 take any K >= 1.
"""

from __future__ import annotations

import ctypes

import torch

from dagsfm_tpu_torch.ops import cuda_build
from dagsfm_tpu_torch.ops.fma import fma32

DESC_DIM = 128
TILE = 128            # K3 keeps the reference's shape rule: multiples of 128
# Largest error allowed to a bf16 kernel's score: the scores are dot
# products of unit-norm descriptors, so the sum of |products| is at most
# about 1 and each of the 128 additions may be off by one f32 ulp at 1.
EPS = 128 * 2.0 ** -23

top2_batch_launches = 0   # K2
top2_launches = 0         # K3
mfu_launches = 0          # K4


def load_library():
    """Build (when the source hash changed) and load the kernel library."""
    lib = cuda_build.load("top2_matcher")["top2_matcher"]
    cuda_build.set_signature(lib.top2_batch_launch, 4,
                             [ctypes.c_int] * 3, 6)
    cuda_build.set_signature(lib.top2_f32_launch, 2, [ctypes.c_int] * 2, 3)
    return lib


# ------------------------------------------------------------ plain versions

def _ordered(a: torch.Tensor, b: torch.Tensor, step) -> torch.Tensor:
    """(..., R, C) f32 scores of a (..., R, D) against b (..., C, D), each
    acc = step(acc, a[k], b[k]) for k = 0..D-1 from acc = 0."""
    a, b = a.float(), b.float()
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[-1]):
        acc = step(acc, a[..., :, None, k], b[..., None, :, k])
    return acc


def ordered_scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scores (`_ordered`) with the product and the sum rounded
    separately at each step (the plain arithmetic of K1, K2 and K4, which
    are within EPS of it)."""
    return _ordered(a, b, lambda acc, x, y: acc + x * y)


def ordered_fma_scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scores (`_ordered`) as ordered chains of fused multiply-adds,
    acc = fma(a[k], b[k], acc), one rounding per step (K3's
    arithmetic)."""
    return _ordered(a, b, fma32)


def _top2_of(sim: torch.Tensor, mode: int):
    """Row best / second / argbest and column argmax of (..., R, C)
    scores, with K4's stage switches (mode 3 = K2 once masked)."""
    shape = sim.shape[:-1]
    if mode == 0:
        best = sim.amax(-1)
        second = torch.full(shape, -torch.inf, device=sim.device)
        idx = torch.zeros(shape, dtype=torch.int64, device=sim.device)
    else:
        best, idx = torch.max(sim, dim=-1)           # first index on ties
        cols = torch.arange(sim.shape[-1], device=sim.device)
        second = torch.where(cols == idx[..., None], -torch.inf, sim).amax(-1)
    if mode >= 2:
        rev = torch.argmax(sim, dim=-2)              # first row on ties
    else:
        rev = torch.zeros(sim.shape[:-2] + sim.shape[-1:], dtype=torch.int64,
                          device=sim.device)
    return best, second, idx.to(torch.int32), rev.to(torch.int32)


def mfu_variant_reference(d1, d2, m1, m2, mode: int):
    """Plain version of K4: bf16-rounded d1, d2 (B, K, D), m1, m2 (B, K)
    bool (read in mode 3 only). Returns best, second (B, K) f32, idx, rev
    (B, K) int32."""
    sim = ordered_scores(d1.to(torch.bfloat16), d2.to(torch.bfloat16))
    if mode >= 3:
        sim = torch.where(m1[:, :, None] & m2[:, None, :], sim, -torch.inf)
    return _top2_of(sim, mode)


def top2_batch_reference(d1, d2, m1, m2):
    """Plain version of K2 (= K4 mode 3)."""
    return mfu_variant_reference(d1, d2, m1, m2, 3)


def score_gap(sim: torch.Tensor, dim: int) -> torch.Tensor:
    """Top-2 gap of (..., R, C) scores along `dim`: the max less the max
    over the other entries (0 for a tied duplicate, inf without a second
    finite entry, nan where every entry is -inf)."""
    best, arg = torch.max(sim, dim=dim, keepdim=True)
    pos = torch.arange(sim.shape[dim], device=sim.device)
    pos = pos.view([-1] + [1] * (-dim - 1))
    second = torch.where(pos == arg, -torch.inf, sim).amax(dim)
    return best.squeeze(dim) - second


def borderline_of_scores(sim: torch.Tensor, eps: float = EPS):
    """(rows, cols) bool masks of (..., R, C) plain scores: the rows whose
    idx and the columns whose rev may flip when every score moves by at
    most eps, i.e. whose top-2 gap is under 2 * eps."""
    return score_gap(sim, -1) < 2 * eps, score_gap(sim, -2) < 2 * eps


def borderline(d1, d2, m1, m2, mode: int = 3, eps: float = EPS):
    """Borderline (rows, cols) of K2 (mode 3) or K4 (`mode`) on these
    inputs, from the plain version's scores: where a kernel's idx or rev
    may differ from the plain version's under the borderline rule."""
    sim = ordered_scores(d1.to(torch.bfloat16), d2.to(torch.bfloat16))
    if mode >= 3:
        sim = torch.where(m1[:, :, None] & m2[:, None, :], sim, -torch.inf)
    return borderline_of_scores(sim, eps)


def top2_reference(d1, d2):
    """Plain version of K3: f32 d1 (K1, D) against d2 (K2, D). Returns
    best, second (K1,) f32 and idx (K1,) int32."""
    best, second, idx, _ = _top2_of(ordered_fma_scores(d1, d2), 1)
    return best, second, idx


# ------------------------------------------------------------------ wrappers

def _batch_launch(fn: str, d1, d2, m1, m2, mode: int):
    if d1.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {d1.device}")
    if d1.dim() != 3:
        raise ValueError(f"{fn}: d1 must be (B, K, {DESC_DIM})")
    B, K, _ = d1.shape
    cuda_build.check_tensors(fn, (
        ("d1", d1, torch.bfloat16, (B, K, DESC_DIM)),
        ("d2", d2, torch.bfloat16, (B, K, DESC_DIM)),
        ("m1", m1, torch.bool, (B, K)),
        ("m2", m2, torch.bool, (B, K))), d1.device)
    lib = load_library()
    dev = d1.device
    best = torch.empty((B, K), dtype=torch.float32, device=dev)
    second = torch.empty((B, K), dtype=torch.float32, device=dev)
    idx = torch.empty((B, K), dtype=torch.int32, device=dev)
    rev = torch.empty((B, K), dtype=torch.int32, device=dev)
    col_key = torch.empty((B, K) if mode >= 2 else (1,), dtype=torch.int64,
                          device=dev)
    err = lib.top2_batch_launch(
        d1.data_ptr(), d2.data_ptr(), m1.data_ptr(), m2.data_ptr(), B, K,
        mode, best.data_ptr(), second.data_ptr(), idx.data_ptr(),
        rev.data_ptr(), col_key.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch error {err}")
    return best, second, idx, rev


def top2_batch(d1, d2, m1, m2):
    """K2: forward top-2 and reverse argmax of B masked pairs.

    CUDA tensors: d1, d2 (B, K, 128) bf16, m1, m2 (B, K) bool, contiguous,
    on one device; anything else raises. CPU tensors run the plain
    version. Returns best, second (B, K) f32 (-inf for a row with every
    column masked), idx (B, K) int32 (0 there) and rev (B, K) int32 (the
    first row attaining each column's max; 0 for an all-masked column)."""
    global top2_batch_launches
    if d1.device.type == "cpu":
        return top2_batch_reference(d1, d2, m1, m2)
    out = _batch_launch("top2_batch", d1, d2, m1, m2, 3)
    top2_batch_launches += 1
    return out


def mfu_variant(d1, d2, m1, m2, mode: int):
    """K4: K2 with its stages switched on one at a time (`mode` 0 product
    + row max, 1 + top-2, 2 + reverse argmax, 3 + masks = K2). Inputs and
    outputs as `top2_batch`; modes 0-2 ignore the masks, mode 0 leaves
    second at -inf and idx at 0, modes 0 and 1 leave rev at 0."""
    global mfu_launches
    if mode not in (0, 1, 2, 3):
        raise ValueError(f"mfu_variant: mode must be 0-3, got {mode}")
    if d1.device.type == "cpu":
        return mfu_variant_reference(d1, d2, m1, m2, mode)
    out = _batch_launch("mfu_variant", d1, d2, m1, m2, mode)
    mfu_launches += 1
    return out


def top2(d1, d2):
    """K3: best, second (K1,) f32 and argbest (K1,) int32 of each row of
    d1 (K1, 128) against all of d2 (K2, 128), f32, no masks; K1 and K2
    must be multiples of 128 (the reference's shape rule). Each score is
    an ordered chain of f32 fused multiply-adds (`ordered_fma_scores`),
    full f32 as the reference's CPU interpret mode computes it; the TPU's
    default-precision f32 product was not. idx is the first column that
    attains best; second is the max over the other columns (a tied
    duplicate gives second = best). One launch is counted per call (the
    tile kernel and, for K2 > 128, the fold of its column tiles). CPU
    tensors run the plain version; CUDA tensors must be f32, contiguous,
    on one device."""
    global top2_launches
    for name, t in (("d1", d1), ("d2", d2)):
        if t.dim() != 2 or t.shape[1] != DESC_DIM or t.shape[0] % TILE \
                or t.shape[0] == 0:
            raise ValueError(f"top2: {name} must be (n * {TILE}, "
                             f"{DESC_DIM}), got {tuple(t.shape)}")
    if d1.device.type == "cpu":
        return top2_reference(d1, d2)
    if d1.device.type != "cuda":
        raise ValueError(f"top2: unsupported device {d1.device}")
    K1, K2 = d1.shape[0], d2.shape[0]
    cuda_build.check_tensors("top2", (
        ("d1", d1, torch.float32, (K1, DESC_DIM)),
        ("d2", d2, torch.float32, (K2, DESC_DIM))), d1.device)
    lib = load_library()
    dev = d1.device
    tiles = K2 // TILE
    out = torch.empty(3 * K1, dtype=torch.float32, device=dev)
    # the column tiles' partial (best, second, idx), folded by a second
    # kernel
    part = torch.empty(3 * tiles * K1 if tiles > 1 else 1,
                       dtype=torch.float32, device=dev)
    err = lib.top2_f32_launch(d1.data_ptr(), d2.data_ptr(), K1, K2,
                              out.data_ptr(), part.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"top2: CUDA launch error {err}")
    best, second = out[:K1], out[K1:2 * K1]
    idx = out[2 * K1:].view(torch.int32)
    top2_launches += 1
    return best, second, idx


def masked_pair(d1, d2, m1, m2):
    """The f32 inputs `match_one_pair` gives K3: invalid d1 rows zeroed,
    invalid d2 rows sunk to -1e6 (not -inf), exactly as the reference: a
    d1 row with a negative sum would then score high against them, so
    parity holds for non-negative (SIFT) descriptors."""
    return (torch.where(m1[:, None], d1.float(), 0.0).contiguous(),
            torch.where(m2[:, None], d2.float(), -1e6).contiguous())


def _match_one_pair(top2_fn, d1, d2, m1, m2, max_ratio, max_distance):
    d1m, d2m = masked_pair(d1, d2, m1, m2)
    best, second, idx = top2_fn(d1m, d2m)
    _, _, rev_idx = top2_fn(d2m, d1m)
    d_best = torch.sqrt(torch.clamp(2.0 - 2.0 * best, min=0.0))
    d_second = torch.sqrt(torch.clamp(2.0 - 2.0 * second, min=1e-12))
    idx = idx.long()
    rows = torch.arange(d1.shape[0], device=d1.device)
    ok = (d_best < max_ratio * d_second) & (d_best < max_distance) & m1
    ok = ok & (rev_idx.long()[idx] == rows) & m2[idx]
    matches = torch.stack([torch.where(ok, rows, -1),
                           torch.where(ok, idx, -1)], dim=-1)
    return matches.to(torch.int32), ok.sum()


def match_one_pair(d1, d2, m1, m2, max_ratio: float = 0.8,
                   max_distance: float = 0.7):
    """Ratio-test + cross-check matcher for ONE pair on K3 (the
    reference's `pallas_match`): two `top2` launches, forward and
    reverse. d1 (K1, 128), d2 (K2, 128); m1 (K1,), m2 (K2,) bool. Returns
    (matches (K1, 2) int32 with -1 pads, num_matches)."""
    return _match_one_pair(top2, d1, d2, m1, m2, max_ratio, max_distance)


def match_one_pair_reference(d1, d2, m1, m2, max_ratio: float = 0.8,
                             max_distance: float = 0.7):
    """`match_one_pair` on the plain version of K3."""
    return _match_one_pair(top2_reference, d1, d2, m1, m2, max_ratio,
                           max_distance)
