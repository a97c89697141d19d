"""Small dense linear algebra, batched over leading dimensions.

Port of dagsfm_tpu/ops/linalg.py (COLMAP's math/ utilities):
  - gauss_jordan            (math/gauss_jordan.h)
  - rq_decomposition        (math/rq_decomposition.h)
  - decompose_projection_matrix
  - matrix_square_root      (math/matrix_square_root)
  - levenberg_marquardt     (math/lm.h, the generic LM)

The JAX package's fixed-trip `lax.scan` loops are Python loops over
tensors here: the same steps in the same order, and no step reads a
value back to the host, so a loop on the card queues without waiting.
Every function computes on its inputs' device and dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def gauss_jordan(A: torch.Tensor, B: torch.Tensor | None = None):
    """Gauss-Jordan elimination with partial pivoting on (n, n) A.

    Returns (A_reduced, X) with X solving A X = B (B defaults to I, so X
    is the inverse). A pivot below 1e-300 in magnitude is replaced by
    1e-300, as in the JAX package."""
    n = A.shape[-1]
    if B is None:
        B = torch.eye(n, dtype=A.dtype, device=A.device)
    M = torch.cat([A, B], dim=-1)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        # partial pivot: swap row k with argmax |M[k:, k]|
        col = torch.where(rows < k, -torch.inf, torch.abs(M[:, k]))
        piv = torch.argmax(col)
        perm = torch.where(rows == k, piv, torch.where(rows == piv, k, rows))
        M = M[perm]
        d = M[k, k]
        d = torch.where(torch.abs(d) < 1e-300, 1e-300, d)
        rowk = M[k] / d
        M = M - torch.outer(M[:, k], rowk)
        M[k] = rowk
    return M[:, :n], M[:, n:]


def rq_decomposition(M: torch.Tensor):
    """M = R Q with R upper triangular and Q orthonormal, by QR of the
    flipped transpose; signs fixed so diag(R) >= 0 (splits a 3 x 4
    projection into K [R | t])."""
    n = M.shape[-2]
    P = torch.flip(torch.eye(n, dtype=M.dtype, device=M.device), dims=(0,))
    Q1, R1 = torch.linalg.qr((P @ M).transpose(-2, -1))
    R = P @ R1.transpose(-2, -1) @ P
    Q = P @ Q1.transpose(-2, -1)
    s = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0, 1.0, s)
    R = R * s[..., None, :]
    Q = Q * s[..., :, None]
    return R, Q


def decompose_projection_matrix(P: torch.Tensor):
    """A 3 x 4 projection P = K [R | t] split into (K, R, t): K with
    K[2, 2] = 1 and a positive diagonal, det(R) = +1."""
    K, R = rq_decomposition(P[..., :3])
    s = torch.sign(torch.diagonal(K, dim1=-2, dim2=-1))
    s = torch.where(s == 0, 1.0, s)
    K = K * s[..., None, :]
    R = R * s[..., :, None]
    d = torch.linalg.det(R)
    R = R * d[..., None, None]
    t = torch.linalg.solve(K, P[..., :, 3:])[..., 0] * d[..., None]
    K = K / K[..., 2:3, 2:3]
    return K, R, t


def matrix_square_root(A: torch.Tensor, num_iters: int = 20) -> torch.Tensor:
    """Principal square root of an SPD matrix: num_iters Denman-Beavers
    steps on A / ||A||_F, scaled back by sqrt(||A||_F)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    nrm = torch.linalg.norm(A, dim=(-2, -1), keepdim=True)
    nrm = torch.where(nrm < 1e-30, 1.0, nrm)
    Y = A / nrm
    Z = torch.broadcast_to(eye, A.shape)
    for _ in range(num_iters):
        Yi = torch.linalg.inv(Y)
        Zi = torch.linalg.inv(Z)
        Y, Z = 0.5 * (Y + Zi), 0.5 * (Z + Yi)
    return Y * torch.sqrt(nrm)


class LMResult(NamedTuple):
    x: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    lam: torch.Tensor


def levenberg_marquardt(residual_fn: Callable, x0: torch.Tensor,
                        max_iterations: int = 50,
                        init_lambda: float = 1e-3) -> LMResult:
    """Dense LM over a flat parameter vector, for small refinements.

    residual_fn: x -> (M,) residuals, written in torch. The Jacobian is
    forward mode (`torch.func.jacfwd`, as the JAX package's `jacfwd`);
    the damped normal equations are solved densely; a step is taken when
    it lowers the cost, and lambda goes down by 3 or up by 4 (clamped to
    [1e-12, 1e8]) through `torch.where`, with no read-back, for
    max_iterations steps."""
    def cost(x):
        r = residual_fn(x)
        return 0.5 * torch.sum(r * r)

    n = x0.shape[0]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    jac = torch.func.jacfwd(residual_fn)
    x = x0
    lam = torch.as_tensor(init_lambda, dtype=x0.dtype, device=x0.device)
    c0 = cost(x0)
    c = c0
    for _ in range(max_iterations):
        r = residual_fn(x)
        J = jac(x)
        H = J.T @ J
        g = J.T @ r
        Hd = H + lam * torch.diag(torch.clamp(torch.diag(H), min=1e-12))
        dx = -torch.linalg.solve(Hd + 1e-12 * eye, g)
        x_new = x + dx
        c_new = cost(x_new)
        accept = c_new < c
        x = torch.where(accept, x_new, x)
        c = torch.where(accept, c_new, c)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12),
                          torch.clamp(lam * 4.0, max=1e8))
    return LMResult(x, c0, c, lam)
