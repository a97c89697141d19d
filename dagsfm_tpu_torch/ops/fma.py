"""Fused multiply-add in f32 with one rounding, in plain PyTorch.

The CUDA kernels and the reference's compiled XLA:CPU programs add a
product to a sum with one fused multiply-add (`fmaf`); a PyTorch multiply
and add round twice. `fma32` gives the fused rounding on any device, so a
plain version can match such a kernel to the bit: SIFT's blur and K3's
plain version (`top2_matcher.ordered_fma_scores`) both use it.
"""

from __future__ import annotations

import math

import torch


def fma32(acc: torch.Tensor, a, b: torch.Tensor) -> torch.Tensor:
    """round_f32(acc + a * b) with one rounding. `acc` and `b` are f32
    tensors, `a` an f32 tensor or a Python float holding an f32 value.

    The product of two f32 values is exact in f64; the f64 sum is made
    round-to-odd (its TwoSum error, then the last bit forced odd toward
    it), and an f64 value rounded to odd rounds to f32 exactly as the
    exact sum would (f64 keeps more than 2 * 24 + 1 bits)."""
    s_acc = acc.double()
    p = (a.double() if torch.is_tensor(a) else a) * b.double()
    s = s_acc + p
    bb = s - s_acc
    e = (s_acc - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)
