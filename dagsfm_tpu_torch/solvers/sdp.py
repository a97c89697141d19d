"""Block-coordinate SDP solver for rotation-averaging relaxations.

Port of dagsfm_tpu/solvers/sdp.py (Theia's solver/ sdp_solver,
bcm_sdp_solver and rbr_sdp_solver). It solves

    max  tr(C Y)   s.t.  Y_kk = I_3,  Y psd

(the Lagrange-dual / Shor relaxation of multiple rotation averaging,
Eriksson et al., "Rotation Averaging and Strong Duality") by block-row
coordinate maximization: each update sets one 3-column block of Y in
closed form through a 3 x 3 inverse square root. Y is a dense (3n, 3n)
matrix on the device. The sweeps are Python loops over tensors, in the
JAX package's order (sweeps x blocks 0..n-1), each update a few small
launches and one 3 x 3 `eigh`.

`eigh`'s eigenvector signs (and the basis of a repeated eigenvalue)
differ between libraries; `_inv_sqrt_psd`'s V diag V^T and
`extract_rotations`' blocks_i blocks_0^T see neither.
"""

from __future__ import annotations

import torch

from dagsfm_tpu_torch.ops.rotations import project_to_rotmat


def _inv_sqrt_psd(S: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """S^(-1/2) of a symmetric psd 3 x 3 (eigenvalues floored at eps)."""
    w, V = torch.linalg.eigh(S)
    w = torch.clamp(w, min=eps)
    return (V / torch.sqrt(w)[None, :]) @ V.T


def solve_block_sdp(C: torch.Tensor, num_blocks: int, sweeps: int = 30):
    """Y maximizing tr(C Y) with identity diagonal blocks, from Y = I, on
    C's device and dtype. C (3n, 3n) symmetric: pass the sign that makes
    the wanted solution a maximum (C = the block matrix of relative
    rotations)."""
    n = num_blocks
    dev, dt = C.device, C.dtype
    Y = torch.eye(3 * n, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    for _ in range(sweeps):
        for k in range(n):
            # B = C[:, 3k:3k+3] with block k zeroed; W = Y with row and
            # column block k zeroed
            maskf = torch.ones(3 * n, dtype=dt, device=dev)
            maskf[3 * k:3 * k + 3] = 0.0
            B = C[:, 3 * k:3 * k + 3] * maskf[:, None]
            # B's block-k rows are zero, so zeroing Y's column block k
            # changes no term of the product: only its rows are masked
            WB = (Y @ B) * maskf[:, None]                        # (3n, 3)
            S = B.T @ WB                                         # (3, 3)
            new_col = WB @ _inv_sqrt_psd(S)
            # if S ~ 0, the column's off-diagonal blocks stay zero
            scale = torch.where(torch.trace(S) > 1e-12, 1.0, 0.0)
            new_col = new_col * scale * maskf[:, None]
            Y[:, 3 * k:3 * k + 3] = new_col
            Y[3 * k:3 * k + 3, :] = new_col.T
            Y[3 * k:3 * k + 3, 3 * k:3 * k + 3] = eye3
    return Y


def extract_rotations(Y: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """Y's rank-3 factor as rotations (n, 3, 3), gauge R_0 = I: the top
    three eigenvectors scaled by sqrt(eigenvalue), block i times block
    0's transpose, projected onto SO(3)."""
    n = num_blocks
    w, V = torch.linalg.eigh(Y)
    top = V[:, -3:] * torch.sqrt(torch.clamp(w[-3:], min=1e-12))[None, :]
    blocks = top.reshape(n, 3, 3)
    Rs = torch.einsum("nij,kj->nik", blocks, blocks[0])
    return project_to_rotmat(Rs)


def rank3_residual(Y: torch.Tensor) -> torch.Tensor:
    """The sum of |eigenvalues| beyond the top three: 0 iff the
    relaxation is tight (the strong-duality certificate)."""
    w = torch.linalg.eigvalsh(Y)
    return torch.sum(torch.abs(w[:-3]))
