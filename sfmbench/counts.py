"""Operations and bytes of the measured kernels and steps, from their
shapes. Each input byte is counted read once and each output byte
written once, whatever the implementation reads again."""

from __future__ import annotations

F64, I64 = 8, 8


def k1_ops(pairs: int, K: int, D: int = 128) -> float:
    """Multiply-adds of the fused matcher's score products, two
    operations each: every row of one image against every row of the
    other."""
    return 2.0 * pairs * K * K * D


def k1_bytes(pairs: int, K: int, D: int = 128) -> float:
    """bf16 descriptors and bool masks of both images in, int32 match
    index per row out."""
    return pairs * (2 * K * D * 2 + 2 * K + 4 * K)


def ba_lm_step_bytes(N: int, P: int, I: int, C: int,
                     cg_per_step: float) -> float:
    """Bytes one Levenberg-Marquardt step of the iterative Schur solver
    with intrinsics (6 pose, 8 intrinsic slots, 3 point unknowns) must
    move, phase by phase, in float64 with int64 indices:

    * residuals and Jacobians: the observations (pixels, image, point
      and camera index) and the parameters in; r (2), Jc (2 x 6), Jg
      (2 x 8) and Jp (2 x 3) per observation out;
    * the Schur prologue: r, Jc, Jg, Jp in; per observation Wc (6 x 3)
      and Wg (8 x 3) out, per point V^-1 (3 x 3) and its gradient (3),
      per image the camera blocks (6 x 6, 8 x 8, 6 x 8) and gradients;
    * each CG iteration: Wc, Wg, V^-1 and the indices in, the product
      out;
    * the trial: the observations and the new parameters in, the cost
      out.
    """
    params = I * (4 + 3) * F64 + C * 12 * F64 + P * 3 * F64
    obs = N * (2 * F64 + 3 * I64)
    jac = N * 2 * (1 + 6 + 8 + 3) * F64
    w_blocks = N * (6 * 3 + 8 * 3) * F64
    point = P * (9 + 3) * F64
    image = I * (36 + 64 + 48 + 6 + 8) * F64
    residual_jacobian = obs + params + jac
    prologue = jac + w_blocks + point + image
    cg = w_blocks + P * 9 * F64 + N * 3 * I64 + I * 14 * F64 * 2
    trial = obs + params
    return residual_jacobian + prologue + cg_per_step * cg + trial
