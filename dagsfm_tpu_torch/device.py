"""Device selection for the port's entry points.

Entry points take `device=None` (meaning the GPU) or an explicit device.
There is no silent CPU fallback: asking for CUDA without a card raises.
"""

from __future__ import annotations

import torch

DTYPE = torch.float64   # geometry, RANSAC and BA run in float64 everywhere


def resolve(device=None) -> torch.device:
    """`cuda` unless the caller names another device; raises when CUDA is
    asked for (explicitly or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dagsfm_tpu_torch: no CUDA device available; pass device='cpu' "
            "to run on the CPU")
    return dev


def as_tensor(x, device, dtype=DTYPE) -> torch.Tensor:
    """Host array -> tensor on `device` (float64 unless told otherwise)."""
    return torch.as_tensor(x, dtype=dtype, device=device)
