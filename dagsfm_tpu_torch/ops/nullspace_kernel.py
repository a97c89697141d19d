"""Nullspace of exact minimal systems: CUDA kernel and plain version.

N = Q[:, r:] of the complete QR of Aᵀ for a batch A (S, r, 9) of the 5-,
7- and 8-row systems of the E, F and H minimal solvers
(`epipolar._nullspace_k`). Replaces no TPU kernel: the JAX package leaves
this QR to XLA's `jnp.linalg.qr`; on the card PyTorch's complete QR runs
one cuSOLVER `orgqr` per matrix. The kernel is
`csrc/minimal_nullspace.cu` (one thread per system), compiled with nvcc
for sm_90a into a shared library with a plain C interface and loaded with
ctypes; see the .cu file for its arithmetic, bound and design.

`minimal_nullspace` launches the kernel for CUDA tensors and runs the
plain PyTorch version (`minimal_nullspace_reference`, the same Householder
steps over the batch) only for CPU tensors; for a CUDA tensor it launches
or raises, never falls back. Both follow LAPACK's dgeqr2 + dorg2r, so N
equals the library's columns to rounding. Each call adds S to the open
root's counter `nullspace_systems` (utils/observability).
"""

from __future__ import annotations

import ctypes

import torch

from dagsfm_tpu_torch.ops import cuda_build
from dagsfm_tpu_torch.utils import observability as obs

launches = 0          # kernel launches (one per minimal_nullspace on a GPU)
ROWS = (5, 7, 8)      # the systems the kernel takes: E, F, H
COLS = 9


def load_library():
    """Build (when the source hash changed) and load the kernel library."""
    lib = cuda_build.load("minimal_nullspace")["minimal_nullspace"]
    cuda_build.set_signature(lib.minimal_nullspace_launch, 2,
                             [ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int], 1)
    return lib


def minimal_nullspace_reference(A: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: A (S, r, n) -> N (S, n, n - r), the last
    n - r columns of Q in the complete QR of Aᵀ, by LAPACK's Householder
    steps (dgeqr2, then dorg2r on the unit columns), r steps over the
    batch."""
    S, r, n = A.shape
    M = A.transpose(-1, -2).clone()                   # (S, n, r)
    vs, taus = [], []
    for j in range(r):
        alpha = M[:, j, j]
        xnorm = torch.linalg.vector_norm(M[:, j + 1:, j], dim=-1)
        h = torch.hypot(alpha, xnorm)
        beta = torch.where(alpha >= 0, -h, h)
        zero = xnorm == 0
        tau = torch.where(zero, 0.0, (beta - alpha) / beta)
        scale = torch.where(zero, 0.0, 1.0 / (alpha - beta))
        v = torch.cat([torch.ones_like(alpha)[:, None],
                       M[:, j + 1:, j] * scale[:, None]], dim=-1)
        C = M[:, j:, j + 1:]
        w = (v[:, :, None] * C).sum(1) * tau[:, None]
        M[:, j:, j + 1:] = C - v[:, :, None] * w[:, None, :]
        vs.append(v)
        taus.append(tau)
    Q = torch.eye(n, dtype=A.dtype, device=A.device)[:, r:].expand(
        S, n, n - r).clone()
    for j in reversed(range(r)):
        v, tau = vs[j], taus[j]
        w = (v[:, :, None] * Q[:, j:]).sum(1) * tau[:, None]
        Q[:, j:] = Q[:, j:] - v[:, :, None] * w[:, None, :]
    return Q


def minimal_nullspace(A: torch.Tensor) -> torch.Tensor:
    """N (S, 9, 9 - r) for A (S, r, 9).

    CUDA tensors: A float64 or float32, contiguous, r in ROWS; anything
    else raises. CPU tensors run the plain version."""
    global launches
    obs.count("nullspace_systems", A.shape[0])
    if A.device.type == "cpu":
        return minimal_nullspace_reference(A)
    if A.device.type != "cuda":
        raise ValueError(f"minimal_nullspace: unsupported device {A.device}")
    if A.dim() != 3 or A.shape[1] not in ROWS or A.shape[2] != COLS:
        raise ValueError(f"minimal_nullspace: A must be (S, r, 9) with r in "
                         f"{ROWS}, got {tuple(A.shape)}")
    S, r, _ = A.shape
    if A.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"minimal_nullspace: A must be float64 or float32, "
                         f"got {A.dtype}")
    cuda_build.check_tensors("minimal_nullspace",
                             (("A", A, A.dtype, (S, r, COLS)),), A.device)
    N = torch.empty((S, COLS, COLS - r), dtype=A.dtype, device=A.device)
    lib = load_library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.minimal_nullspace_launch(A.data_ptr(), N.data_ptr(), S, r,
                                       int(A.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"minimal_nullspace: CUDA launch error {err}")
    launches += 1
    return N
