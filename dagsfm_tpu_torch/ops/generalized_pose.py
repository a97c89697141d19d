"""Generalized (multi-camera) pose solvers: the pose of a camera rig from
rays that do not share a centre.

Port of dagsfm_tpu/ops/generalized_pose.py. Both problems are linear
lifts solved with one small decomposition per hypothesis, batched over
every leading dim (RANSAC's pairs and hypotheses) on the inputs' device:

  - absolute (`gpnp`): each world point X on the rig-frame ray (o, d)
    gives cross(d, R X + t - o) = 0, three linear equations in the 12
    entries of [R | t]; the lift's normal equations are solved, R is
    scaled by the cube root of its determinant and projected onto SO(3),
    and 10 Gauss-Newton steps on the ray residual polish (R, t);
  - relative (`generalized_relative_pose_17pt`): the generalized
    epipolar constraint d2ᵀ E d1 + d2ᵀ R m1 + m2ᵀ R d1 = 0 (Plücker
    moments m = c x d) is linear in (E, R); the last right singular
    vector of the (N, 18) system gives both, R is projected onto SO(3)
    and t read from E Rᵀ = [t]x.

Models are (..., 1, 3, 4) [R | t] with validity (..., 1), the shapes
`ops.ransac.ransac` takes from a solver. The residuals broadcast a
model's leading dims against the data's.
"""

from __future__ import annotations

import torch

from dagsfm_tpu_torch.ops import rotations as rops


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a positive tensor (within an ulp of a true cbrt)."""
    return torch.pow(x, 1.0 / 3.0)


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation; the safe norm sqrt(|w|^2 + 1e-24)
    keeps the forward-mode derivative finite at w = 0."""
    th = torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)[..., None, None]
    K = rops.skew(w / th[..., 0])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)


def gpnp(points: torch.Tensor, ray_origins: torch.Tensor,
         ray_dirs: torch.Tensor, refine_iters: int = 10):
    """Rig pose from n >= 6 point-ray correspondences: points (..., N, 3)
    in the world, ray origins and directions (..., N, 3) in the rig frame
    (directions need not be unit). Returns (M (..., 1, 3, 4), valid
    (..., 1)) with x_rig = R x_world + t; valid when most points lie in
    front along their rays and t is finite."""
    d = _unit(ray_dirs)
    X, o = points, ray_origins
    lead, n = X.shape[:-2], X.shape[-2]
    S = rops.skew(d)                                      # (..., N, 3, 3)
    # unknowns m = [r11 .. r33 row-major, t1 .. t3]
    A_rot = torch.einsum("...nab,...nc->...nabc", S, X).reshape(
        lead + (n, 3, 9))
    A = torch.cat([A_rot, S], -1).reshape(lead + (3 * n, 12))
    b = torch.einsum("...nab,...nb->...na", S, o).reshape(lead + (3 * n,))
    At = A.transpose(-1, -2)
    AtA = At @ A + 1e-12 * torch.eye(12, dtype=A.dtype, device=A.device)
    m = torch.linalg.solve(AtA, (At @ b[..., None]))[..., 0]
    R_raw = m[..., :9].reshape(lead + (3, 3))
    s = _cbrt(torch.clamp(torch.abs(torch.linalg.det(R_raw)), min=1e-12))
    R = rops.project_to_rotmat(R_raw / s[..., None, None])
    t = m[..., 9:] / s[..., None]

    def residual(params):
        Rp = _rodrigues(params[..., :3]) @ R
        P = X @ Rp.transpose(-1, -2) + params[..., None, 3:]
        return torch.linalg.cross(d, P - o, dim=-1).reshape(lead + (3 * n,))

    params = torch.cat([torch.zeros_like(t), t], -1)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(refine_iters):
        r, cols = None, []
        for k in range(6):        # forward mode, one tangent per column
            r, col = torch.func.jvp(residual, (params,),
                                    (eye6[k].expand(params.shape),))
            cols.append(col)
        J = torch.stack(cols, -1)                         # (..., 3N, 6)
        Jt = J.transpose(-1, -2)
        H = Jt @ J + 1e-9 * eye6
        params = params - torch.linalg.solve(H, Jt @ r[..., None])[..., 0]
    R = _rodrigues(params[..., :3]) @ R
    t = params[..., 3:]

    depth = torch.sum((X @ R.transpose(-1, -2) + t[..., None, :] - o) * d,
                      dim=-1)
    valid = ((depth > 0).to(X.dtype).mean(-1) > 0.5) & \
        torch.isfinite(t).all(-1)
    M = torch.cat([R, t[..., None]], -1)
    return M[..., None, :, :], valid[..., None]


def gpnp_ray_residual(M: torch.Tensor, points: torch.Tensor,
                      ray_origins: torch.Tensor,
                      ray_dirs: torch.Tensor) -> torch.Tensor:
    """Squared point-to-ray distance (..., N) of each point under the
    pose M (..., 3, 4)."""
    R, t = M[..., :3], M[..., 3]
    P = points @ R.transpose(-1, -2) + t[..., None, :] - ray_origins
    e = torch.linalg.cross(_unit(ray_dirs).expand(P.shape), P, dim=-1)
    return torch.sum(e * e, dim=-1)


def _plucker(q, c):
    """(directions, Plücker moments c x d) as the reference forms them:
    its `jnp.linalg.norm(q, -1, keepdims=True)` passes -1 as the order,
    so every ray of a set is divided by one number, the matrix norm
    min_j sum_n |q_nj| of the set's (N, 3) directions, not by its own
    length. The solver's null vector does not change with it; the GEC
    residual scales with its square."""
    n = torch.amin(torch.sum(torch.abs(q), dim=-2, keepdim=True), dim=-1,
                   keepdim=True)
    d = q / torch.clamp(n, min=1e-12)
    return d, torch.linalg.cross(c.expand(d.shape), d, dim=-1)


def generalized_relative_pose_17pt(q1: torch.Tensor, c1: torch.Tensor,
                                   q2: torch.Tensor, c2: torch.Tensor):
    """Linear 17-point generalized relative pose (Li & Hartley 2008).

    Ray n: direction q1 from centre c1 in rig 1's frame, q2 from c2 in
    rig 2's, all (..., N, 3) with N >= 17. Returns (M (..., 1, 3, 4),
    valid (..., 1)) with x_2 = R x_1 + t."""
    d1, m1 = _plucker(q1, c1)
    d2, m2 = _plucker(q2, c2)
    lead, n = d1.shape[:-2], d1.shape[-2]
    A_E = torch.einsum("...ni,...nj->...nij", d2, d1).reshape(lead + (n, 9))
    A_R = (torch.einsum("...ni,...nj->...nij", d2, m1)
           + torch.einsum("...ni,...nj->...nij", m2, d1)).reshape(
        lead + (n, 9))
    _, _, Vt = torch.linalg.svd(torch.cat([A_E, A_R], -1),
                                full_matrices=True)
    v = Vt[..., -1, :]
    E = v[..., :9].reshape(lead + (3, 3))
    R_raw = v[..., 9:].reshape(lead + (3, 3))
    det = torch.linalg.det(R_raw)
    s = _cbrt(torch.clamp(torch.abs(det), min=1e-18))[..., None, None]
    sign = torch.sign(det)[..., None, None]
    # the singular vector's sign cancels in R and E
    R = rops.project_to_rotmat(R_raw / s * sign)
    E = E / s * sign
    T = E @ R.transpose(-1, -2)                     # [t]x = E Rᵀ
    Ts = 0.5 * (T - T.transpose(-1, -2))
    t = torch.stack([Ts[..., 2, 1], Ts[..., 0, 2], Ts[..., 1, 0]], -1)
    valid = torch.isfinite(t).all(-1) & \
        (torch.linalg.norm(v[..., 9:], dim=-1) > 1e-12)
    M = torch.cat([R, t[..., None]], -1)
    return M[..., None, :, :], valid[..., None]


def gec_residual(M: torch.Tensor, q1, c1, q2, c2) -> torch.Tensor:
    """Squared generalized-epipolar-constraint violation (..., N) of each
    ray pair under the relative pose M (..., 3, 4)."""
    R, t = M[..., :3], M[..., 3]
    d1, m1 = _plucker(q1, c1)
    d2, m2 = _plucker(q2, c2)
    E = rops.skew(t) @ R
    r = (torch.einsum("...ni,...ij,...nj->...n", d2, E, d1)
         + torch.einsum("...ni,...ij,...nj->...n", d2, R, m1)
         + torch.einsum("...ni,...ij,...nj->...n", m2, R, d1))
    return r * r
