"""ADMM solvers: L1 regression, constrained L1 and box-constrained QP.

Port of dagsfm_tpu/solvers/admm.py (Theia's solver/ admm, l1_solver,
constrained_l1_solver and qp_solver). The normal equations are
Cholesky-factored once per problem; each solver then runs a fixed number
of ADMM steps, the JAX package's `lax.scan` as a Python loop over
tensors that never reads a value back, so on the card the whole loop is
queued at once. Convergence is reported, not branched on. Every solver
computes on its inputs' device and dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ADMMOptions(NamedTuple):
    rho: float = 1.0
    alpha: float = 1.0          # over-relaxation
    max_iterations: int = 100


def _shrink(x, kappa):
    """Soft thresholding: the prox of the L1 norm."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - kappa, min=0.0)


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def l1_regression(A: torch.Tensor, b: torch.Tensor,
                  opts: ADMMOptions = ADMMOptions()):
    """min_x ||A x - b||_1 by ADMM (Theia's L1Solver).

    A (M, N), b (M,). Returns (x, primal_residual, dual_residual)."""
    M, N = A.shape
    L = torch.linalg.cholesky(
        A.T @ A + 1e-12 * torch.eye(N, dtype=A.dtype, device=A.device))
    x = torch.zeros(N, dtype=A.dtype, device=A.device)
    z = torch.zeros(M, dtype=A.dtype, device=A.device)
    u = torch.zeros(M, dtype=A.dtype, device=A.device)
    for _ in range(opts.max_iterations):
        # x-update: argmin ||A x - (b + z - u)||^2
        x = _cho_solve(L, A.T @ (b + z - u))
        Ax = A @ x
        Ax_hat = opts.alpha * Ax + (1 - opts.alpha) * (z + b)
        z = _shrink(Ax_hat - b + u, 1.0 / opts.rho)
        u = u + Ax_hat - z - b
    primal = torch.linalg.norm(A @ x - b - z)
    dual = torch.linalg.norm(opts.rho * A.T @ (z - (A @ x - b)))
    return x, primal, dual


def constrained_l1(A: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                   d: torch.Tensor, opts: ADMMOptions = ADMMOptions()):
    """min ||A x - b||_1 subject to C x >= d (Theia's
    ConstrainedL1Solver): an inequality block stacked under A, its prox
    the projection of C x - d onto the nonnegative orthant."""
    M, N = A.shape
    K = C.shape[0]
    G = torch.cat([A, C], dim=0)                       # (M + K, N)
    h = torch.cat([b, d], dim=0)
    L = torch.linalg.cholesky(
        G.T @ G + 1e-12 * torch.eye(N, dtype=A.dtype, device=A.device))
    x = torch.zeros(N, dtype=A.dtype, device=A.device)
    z = torch.zeros(M + K, dtype=A.dtype, device=A.device)
    u = torch.zeros(M + K, dtype=A.dtype, device=A.device)
    for _ in range(opts.max_iterations):
        x = _cho_solve(L, G.T @ (h + z - u))
        Gx = G @ x
        v = Gx - h + u
        # first M entries: soft threshold (L1); last K: project >= 0
        z = torch.cat([_shrink(v[:M], 1.0 / opts.rho),
                       torch.clamp(v[M:], min=0.0)])
        u = u + Gx - h - z
    return x


def box_qp(P: torch.Tensor, q: torch.Tensor, lb: torch.Tensor,
           ub: torch.Tensor, opts: ADMMOptions = ADMMOptions()):
    """min 1/2 x^T P x + q^T x subject to lb <= x <= ub (Theia's
    QPSolver), by ADMM with the box projection as prox. Returns z, the
    feasible iterate."""
    N = P.shape[0]
    L = torch.linalg.cholesky(
        P + opts.rho * torch.eye(N, dtype=P.dtype, device=P.device))
    z = torch.clamp(torch.zeros(N, dtype=P.dtype, device=P.device), lb, ub)
    x = z
    u = torch.zeros(N, dtype=P.dtype, device=P.device)
    for _ in range(opts.max_iterations):
        x = _cho_solve(L, opts.rho * (z - u) - q)
        z = torch.clamp(x + u, lb, ub)
        u = u + x - z
    return z
