"""Batched linear solves with the reference's failure semantics.

JAX's `jnp.linalg.solve` and `jax.scipy.linalg.cho_factor` do not raise
on a singular or indefinite matrix: the result holds inf / NaN, and the
caller's finiteness and cost checks reject it (a RANSAC hypothesis that
scores nothing, an LM step that is not taken). `torch.linalg.solve` and
`torch.linalg.cholesky` raise instead, so the port solves through the
`_ex` variants and writes NaN where the factorisation failed. They also
skip the device sync that the raising variants make to read the error.
"""

from __future__ import annotations

import torch


def solve_or_nan(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A X = B over the batch; NaN where A is singular."""
    X, info = torch.linalg.solve_ex(A, B)
    bad = (info != 0).reshape(info.shape + (1,) * (X.dim() - info.dim()))
    return torch.where(bad, torch.full_like(X, torch.nan), X)


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A; NaN where A is not positive-definite."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, torch.nan), L)
