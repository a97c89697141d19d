"""Absolute pose: Grunert P3P, EPnP, reprojection error, refinement.

Port of `p3p`, `epnp`, `pose_reproj_error` and `refine_pose` from
dagsfm_tpu/ops/absolute_pose.py, over leading batch dims.
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


_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _pair_diffs(c: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) control points -> (..., 6, 3) pairwise differences."""
    return torch.stack([c[..., i, :] - c[..., j, :] for i, j in _PAIRS], -2)


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the pseudo-inverse (SVD, as
    jnp.linalg.lstsq; on CUDA, torch.linalg.lstsq is QR only and needs
    full rank)."""
    return (torch.linalg.pinv(A) @ b[..., None])[..., 0]


def epnp(points: torch.Tensor, uv: torch.Tensor, mask=None,
         gn_iters: int = 8):
    """EPnP (Lepetit et al.) with Gauss-Newton refinement of the betas,
    over a leading batch: points (B, N, 3), uv (B, N, 2), mask (B, N).
    Returns (R (B, 3, 3), t (B, 3), ok (B,)). As the reference: control
    points from the weighted centroid and principal directions, the four
    smallest eigenvectors of MᵀM, the beta cases N = 1, 2, 3 each refined
    and the one of least reprojection error kept. eigh's signs and
    near-degenerate bases differ between libraries; the betas and the
    flip to positive depth absorb a sign, so R and t agree."""
    B, N = points.shape[:2]
    dt, dev = points.dtype, points.device
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    w = mask.to(dt)
    wsum = torch.clamp(w.sum(-1), min=1.0)

    cw0 = (points * w[..., None]).sum(-2) / wsum[:, None]
    centered = (points - cw0[:, None]) * w[..., None]
    cov = centered.transpose(-1, -2) @ centered / wsum[:, None, None]
    bad = ~torch.isfinite(cov).all(-1).all(-1)
    evals, evecs = torch.linalg.eigh(torch.where(bad[:, None, None], 0.0,
                                                 cov))
    scale = torch.sqrt(torch.clamp(evals, min=1e-12))
    ctrl_w = torch.cat([cw0[:, None],
                        cw0[:, None] + (evecs * scale[:, None, :])
                        .transpose(-1, -2)], 1)                # (B, 4, 3)

    ones4 = torch.ones((B, 1, 4), dtype=dt, device=dev)
    M44 = torch.cat([ctrl_w.transpose(-1, -2), ones4], 1)     # (B, 4, 4)
    rhs = torch.cat([points.transpose(-1, -2),
                     torch.ones((B, 1, N), dtype=dt, device=dev)], 1)
    alphas = lin.solve_or_nan(M44, rhs).transpose(-1, -2)     # (B, N, 4)

    u, v = uv[..., 0], uv[..., 1]
    aw = alphas * w[..., None]
    zero = torch.zeros_like(aw)
    # u-rows (a_j, 0, -u a_j), v-rows (0, a_j, -v a_j) per control j
    Mu = torch.stack([aw, zero, -u[..., None] * aw], -1).reshape(B, N, 12)
    Mv = torch.stack([zero, aw, -v[..., None] * aw], -1).reshape(B, N, 12)
    M = torch.stack([Mu, Mv], 2).reshape(B, 2 * N, 12)
    MtM = M.transpose(-1, -2) @ M
    bad = bad | ~torch.isfinite(MtM).all(-1).all(-1)
    _, V = torch.linalg.eigh(torch.where(bad[:, None, None], 0.0, MtM))
    vset = V[..., :4].transpose(-1, -2).reshape(B, 4, 4, 3)   # (B, k, c, 3)

    dw = torch.linalg.norm(_pair_diffs(ctrl_w), dim=-1)       # (B, 6)
    dd = _pair_diffs(vset)                                    # (B, 4, 6, 3)
    dv = torch.linalg.norm(dd, dim=-1)                        # (B, 4, 6)

    def sq(k, l):
        return (torch.sum(dd[:, k] * dd[:, k], -1),
                2 * torch.sum(dd[:, k] * dd[:, l], -1),
                torch.sum(dd[:, l] * dd[:, l], -1))

    zb = torch.zeros(B, dtype=dt, device=dev)
    b1 = torch.sum(dv[:, 0] * dw, -1) / torch.clamp(
        torch.sum(dv[:, 0] * dv[:, 0], -1), min=1e-18)
    betas_c1 = torch.stack([b1, zb, zb, zb], -1)

    f11, f12, f22 = sq(0, 1)
    sol2 = _lstsq(torch.stack([f11, f12, f22], -1), dw * dw)
    b1s = torch.sqrt(torch.clamp(torch.abs(sol2[:, 0]), min=1e-18))
    b2s = torch.sqrt(torch.clamp(torch.abs(sol2[:, 2]), min=1e-18)) * \
        torch.sign(sol2[:, 1]) * torch.sign(sol2[:, 0] + 1e-30)
    betas_c2 = torch.stack([b1s, b2s, zb, zb], -1)

    _, f13b, _ = sq(0, 2)
    _, f23b, _ = sq(1, 2)
    sol3 = _lstsq(torch.stack([f11, f12, f22, f13b, f23b], -1), dw * dw)
    b1t = torch.sqrt(torch.clamp(torch.abs(sol3[:, 0]), min=1e-18))
    b2t = torch.sqrt(torch.clamp(torch.abs(sol3[:, 2]), min=1e-18)) * \
        torch.sign(sol3[:, 1])
    b3t = sol3[:, 3] / torch.clamp(b1t, min=1e-12)
    betas_c3 = torch.stack([b1t, b2t, b3t, zb], -1)

    eye4 = torch.eye(4, dtype=dt, device=dev)
    cands = []
    for betas in (betas_c1, betas_c2, betas_c3):
        for _ in range(gn_iters):
            # residual |sum_k b_k dd_k| - dw over the 6 pairs and its
            # Jacobian (the norm's derivative, as jacfwd gives it)
            diff = torch.einsum("bk,bkpd->bpd", betas, dd)    # (B, 6, 3)
            dist = torch.linalg.norm(diff, dim=-1)
            r = dist - dw
            J = torch.einsum("bpd,bkpd->bpk", diff / dist[..., None], dd)
            JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye4
            betas = betas - lin.solve_or_nan(
                JtJ, (J.transpose(-1, -2) @ r[..., None]))[..., 0]
        cands.append(betas)

    Rs, ts, errs = [], [], []
    for betas in cands:
        ctrl_c = torch.einsum("bk,bkcd->bcd", betas, vset)
        pts_c = alphas @ ctrl_c                               # (B, N, 3)
        depth = torch.sum(pts_c[..., 2] * w, -1)
        pts_c = pts_c * torch.where(depth < 0, -1.0, 1.0)[:, None, None]
        _, R, t = ume.umeyama(points, pts_c, w=w, with_scale=False)
        proj = points @ R.transpose(-1, -2) + t[:, None]
        z = proj[..., 2]
        zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
        e = torch.sum((proj[..., :2] / zs[..., None] - uv) ** 2, -1)
        errs.append(torch.sum(torch.where(mask, e, 0.0), -1))
        Rs.append(R)
        ts.append(t)
    errs = torch.stack(errs, -1)                              # (B, 3)
    errs = torch.where(bad[:, None], torch.nan, errs)
    # first minimum, as jnp.argmin; a NaN error loses to any number
    best = torch.argmin(torch.where(torch.isnan(errs), torch.inf, errs), -1)
    ar = torch.arange(B, device=dev)
    R = torch.stack(Rs, 1)[ar, best]
    t = torch.stack(ts, 1)[ar, best]
    return R, t, torch.isfinite(errs[ar, best])


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
