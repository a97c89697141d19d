"""Absolute pose: Grunert P3P, reprojection error, pose refinement.

Port of `p3p`, `pose_reproj_error` and `refine_pose` from
dagsfm_tpu/ops/absolute_pose.py (EPnP waits for a later slice).
World->cam (R, t); `uv` are normalized image coordinates.
"""

from __future__ import annotations

import torch

from dagsfm_tpu_torch.ops import polynomials as poly
from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.ops import solve as lin
from dagsfm_tpu_torch.ops import umeyama as ume


def _bearings(uv: torch.Tensor) -> torch.Tensor:
    f = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def p3p(points: torch.Tensor, uv: torch.Tensor):
    """Grunert P3P over leading batch dims: points (..., 3, 3), uv
    (..., 3, 2). Returns (R (..., 4, 3, 3), t (..., 4, 3), valid (..., 4))
    with Haralick et al.'s quartic coefficients, as the reference."""
    f = _bearings(uv)
    A, B, C = points[..., 0, :], points[..., 1, :], points[..., 2, :]
    a = torch.linalg.norm(B - C, dim=-1)
    b = torch.linalg.norm(A - C, dim=-1)
    c = torch.linalg.norm(A - B, dim=-1)
    cos_a = torch.sum(f[..., 1, :] * f[..., 2, :], -1)
    cos_b = torch.sum(f[..., 0, :] * f[..., 2, :], -1)
    cos_g = torch.sum(f[..., 0, :] * f[..., 1, :], -1)

    b2 = torch.clamp(b * b, min=1e-18)
    acb = (a * a - c * c) / b2
    apb = (a * a + c * c) / b2
    bcb = (b * b - c * c) / b2
    bab = (b * b - a * a) / b2

    A4 = (acb - 1.0) ** 2 - 4.0 * (c * c / b2) * cos_a ** 2
    A3 = 4.0 * (acb * (1.0 - acb) * cos_b
                - (1.0 - apb) * cos_a * cos_g
                + 2.0 * (c * c / b2) * cos_a ** 2 * cos_b)
    A2 = 2.0 * (acb ** 2 - 1.0
                + 2.0 * acb ** 2 * cos_b ** 2
                + 2.0 * bcb * cos_a ** 2
                - 4.0 * apb * cos_a * cos_b * cos_g
                + 2.0 * bab * cos_g ** 2)
    A1 = 4.0 * (-acb * (1.0 + acb) * cos_b
                + 2.0 * (a * a / b2) * cos_g ** 2 * cos_b
                - (1.0 - apb) * cos_a * cos_g)
    A0 = (1.0 + acb) ** 2 - 4.0 * (a * a / b2) * cos_g ** 2

    v, vmask = poly.solve_quartic_real(A4, A3, A2, A1, A0)   # (..., 4)
    e = (lambda x: x[..., None])
    den_u = 2.0 * (e(cos_g) - v * e(cos_a))
    den_u = torch.where(torch.abs(den_u) < 1e-14,
                        torch.full_like(den_u, 1e-14), den_u)
    u = ((-1.0 + e(acb)) * v * v - 2.0 * e(acb) * e(cos_b) * v
         + 1.0 + e(acb)) / den_u
    den_s1 = torch.clamp(1.0 + v * v - 2.0 * v * e(cos_b), min=1e-14)
    s1 = torch.sqrt(e(b2) / den_s1)
    s2 = u * s1
    s3 = v * s1
    cam = torch.stack([s1[..., None] * f[..., None, 0, :],
                       s2[..., None] * f[..., None, 1, :],
                       s3[..., None] * f[..., None, 2, :]], dim=-2)
    world = points[..., None, :, :].expand(cam.shape)
    _, R, t = ume.umeyama(world, cam, with_scale=False)
    ok = (s1 > 0) & (s2 > 0) & (s3 > 0)
    return R, t, vmask & ok


def pose_reproj_error(R, t, points, uv):
    """Squared reprojection error in normalized coords; points behind the
    camera get 1e12. R (..., 3, 3), t (..., 3), points (..., N, 3),
    uv (..., N, 2); leading dims broadcast."""
    proj = points @ R.transpose(-1, -2) + t[..., None, :]
    z = proj[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    e = proj[..., :2] / zs[..., None] - uv
    err = torch.sum(e * e, dim=-1)
    return torch.where(z > 0, err, torch.full_like(err, 1e12))


def _pinhole_residual_jac(q, t, points, uv, zmin: float):
    """Residual Xc[:2]/z - uv (N, 2) and its Jacobian (N, 2, 6) w.r.t. the
    local (so(3) left increment, translation) update, z clamped at zmin.

    Analytic form of the reference's forward-mode jacobian at a zero
    increment: dXc/dw = -[R X]x, dXc/dt = I."""
    v = rops.quat_rotate(q, points)                        # R X
    Xc = v + t
    z = Xc[..., 2]
    clamped = torch.abs(z) < zmin
    zs = torch.where(clamped, torch.full_like(z, zmin), z)
    r = Xc[..., :2] / zs[..., None] - uv
    inv = 1.0 / zs
    dz = torch.where(clamped, torch.zeros_like(z), -1.0 / (zs * zs))
    zero = torch.zeros_like(z)
    # d(proj)/d(Xc): (..., 2, 3)
    dP = torch.stack([torch.stack([inv, zero, Xc[..., 0] * dz], -1),
                      torch.stack([zero, inv, Xc[..., 1] * dz], -1)], -2)
    dXc = torch.cat([-rops.skew(v), torch.eye(3, dtype=v.dtype,
                                              device=v.device).expand(
                                                  v.shape[:-1] + (3, 3))],
                    dim=-1)                                # (..., 3, 6)
    return r, dP @ dXc


def refine_pose(R, t, points, uv, mask, num_iters: int = 20,
                loss_scale: float = 1e-2):
    """Pose-only Gauss-Newton with Cauchy IRLS weights (fixed trip count).
    points (N, 3), uv (N, 2) normalized, mask (N,). Returns (R, t)."""
    dtype = points.dtype
    q = rops.rotmat_to_quat(R)
    maskf = mask.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=points.device)
    for _ in range(num_iters):
        r, J = _pinhole_residual_jac(q, t, points, uv, 1e-9)
        r2 = torch.sum(r * r, dim=-1)
        w = (1.0 / (1.0 + r2 / (loss_scale ** 2))) * maskf
        JtJ = torch.einsum("n,nri,nrj->ij", w, J, J) + 1e-8 * eye6
        Jtr = torch.einsum("n,nri,nr->i", w, J, r)
        delta = -lin.solve_or_nan(JtJ, Jtr)
        q = rops.quat_normalize(rops.quat_multiply(
            rops.angleaxis_to_quat(delta[:3]), q))
        t = t + delta[3:]
    return rops.quat_to_rotmat(q), t
