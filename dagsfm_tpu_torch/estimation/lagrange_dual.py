"""Lagrange-dual (SDP) rotation averaging and nonlinear refinement.

Port of dagsfm_tpu/estimation/lagrange_dual.py (Theia's
rotation_estimation/ lagrange_dual_rotation_estimator, the SDP
relaxation of Eriksson et al. solved by block-coordinate updates, and
nonlinear_rotation_estimator, least squares over the pairwise rotation
errors). With rotation_averaging.py (L1 then IRLS) this covers COLMAP's
and Theia's rotation estimators. Both run on `device`, the GPU unless
"cpu" is asked for.
"""

from __future__ import annotations

import numpy as np

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.estimation import rotation_averaging as ra
from dagsfm_tpu_torch.solvers import sdp


def estimate_rotations_lagrange_dual(num_images: int, edges: np.ndarray,
                                     rel_rot: np.ndarray,
                                     sweeps: int = 50, device=None):
    """Global rotations from the SDP relaxation: the (3n, 3n) block cost
    C with C_ij = R_ij^T (so tr(C Y) rewards Y_ij = R_i R_j^T near
    R_ij^T), solved by the block-coordinate SDP, rank-3 rotations
    extracted. edges (E, 2), rel_rot (E, 3, 3) with R_j = R_ij R_i.
    Returns ((I, 3, 3) rotations with R_0 = I, the rank-3 residual)."""
    dev = devmod.resolve(device)
    n = num_images
    C = np.zeros((3 * n, 3 * n))
    for (e, (i, j)) in enumerate(edges):
        i, j = int(i), int(j)
        C[3 * i:3 * i + 3, 3 * j:3 * j + 3] += rel_rot[e].T
        C[3 * j:3 * j + 3, 3 * i:3 * i + 3] += rel_rot[e]
    Y = sdp.solve_block_sdp(devmod.as_tensor(C, dev), n, sweeps=sweeps)
    Rs = sdp.extract_rotations(Y, n).cpu().numpy()
    cert = float(sdp.rank3_residual(Y))
    # re-anchor the gauge at camera 0
    Rs = np.einsum("nij,kj->nik", Rs, Rs[0])
    return Rs, cert


def estimate_rotations_nonlinear(num_images: int, edges: np.ndarray,
                                 rel_rot: np.ndarray,
                                 init: np.ndarray | None = None,
                                 iterations: int = 50, device=None):
    """Least-squares refinement over the relative-rotation residuals:
    the IRLS loop of rotation_averaging with unit weights (sigma 1e6
    degrees) and no L1 steps, from `init` or the spanning tree. Returns
    (I, 3, 3) with R_0 = I."""
    dev = devmod.resolve(device)
    opts = ra.RAOptions(l1_iterations=0, irls_iterations=iterations,
                        sigma_deg=1e6)
    R0 = ra.spanning_tree_init(num_images, edges, rel_rot) \
        if init is None else init
    R = ra._solve_ra_local(devmod.as_tensor(R0, dev), edges,
                           devmod.as_tensor(rel_rot, dev), opts)
    return ra._reanchored(R)
