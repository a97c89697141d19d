"""Rig-constrained bundle adjustment.

Port of dagsfm_tpu/sfm/rig_bundle_adjustment.py (COLMAP's
RigBundleAdjuster): every image's pose is cam_from_world = cam_from_rig ∘
rig_from_world, so the images of one snapshot share a 6-dof rig pose and
each rig camera has one 6-dof mount (held constant unless
`refine_relative_poses`).

The parameters are so(3) increments on both pose groups, translation
increments and point increments, in one flat vector [rig w (3S), rig t
(3S), mount w (3C), mount t (3C), points (3P)]. The LM loop is the
reference's, step for step: exactly `max_iterations` iterations, the
gauge fixed by pinning snapshot 0's rig pose and mount 0, the dense
normal equations H = JᵀJ with λ·max(diag H, 1e-6) damping and the
identity on pinned parameters, one dense solve, the step taken when the
cost goes down, λ halved on accept and quadrupled on reject. Every
iteration runs on the device without a host sync.

The reference builds J with `jax.jacfwd` over all parameters, which
holds a (parameters × residuals) intermediate per operation. Here J is
scattered from the analytic per-observation blocks (3 + 3 rig, 3 + 3
mount and 3 point columns per residual pair): the same J up to rounding,
2N × (6S + 6C + 3P) float64 values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dagsfm_tpu_torch.ops import rotations as rops


class RigBAProblem(NamedTuple):
    snap_idx: torch.Tensor   # (N,) observation -> snapshot index
    cam_idx: torch.Tensor    # (N,) observation -> rig-camera (mount) index
    pt_idx: torch.Tensor     # (N,) observation -> point index
    obs_xy: torch.Tensor     # (N, 2) pixels
    focal: torch.Tensor      # (C,) pinhole focal per mount
    pp: torch.Tensor         # (C, 2) principal points
    rig_q: torch.Tensor      # (S, 4) rig-from-world
    rig_t: torch.Tensor      # (S, 3)
    mount_q: torch.Tensor    # (C, 4) cam-from-rig
    mount_t: torch.Tensor    # (C, 3)
    points: torch.Tensor     # (P, 3)


class RigBAOptions(NamedTuple):
    max_iterations: int = 30
    refine_relative_poses: bool = True   # COLMAP's RigBundleAdjuster option
    lam0: float = 1e-3


class RigBAResult(NamedTuple):
    rig_q: torch.Tensor
    rig_t: torch.Tensor
    mount_q: torch.Tensor
    mount_t: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor   # 0-d
    final_cost: torch.Tensor


_PARAMS = ("rig_q", "rig_t", "mount_q", "mount_t", "points")


def _exp_q(w: torch.Tensor) -> torch.Tensor:
    """so(3) -> unit quaternion (wxyz) with the reference's safe norm."""
    th = torch.sqrt(torch.sum(w * w, dim=-1, keepdim=True) + 1e-24)
    half = 0.5 * th
    return rops.quat_normalize(
        torch.cat([torch.cos(half), torch.sin(half) / th * w], -1))


def _split(delta: torch.Tensor, S: int, C: int, P: int) -> tuple:
    return (delta[:3 * S].reshape(S, 3), delta[3 * S:6 * S].reshape(S, 3),
            delta[6 * S:6 * S + 3 * C].reshape(C, 3),
            delta[6 * S + 3 * C:6 * S + 6 * C].reshape(C, 3),
            delta[6 * S + 6 * C:].reshape(P, 3))


def _apply(prob: RigBAProblem, delta: torch.Tensor,
           refine_mounts: bool) -> RigBAProblem:
    """The problem moved by a parameter increment."""
    S, C, P = prob.rig_q.shape[0], prob.mount_q.shape[0], \
        prob.points.shape[0]
    d_rw, d_rt, d_mw, d_mt, d_p = _split(delta, S, C, P)
    out = prob._replace(rig_q=rops.quat_multiply(_exp_q(d_rw), prob.rig_q),
                        rig_t=prob.rig_t + d_rt, points=prob.points + d_p)
    if refine_mounts:
        out = out._replace(
            mount_q=rops.quat_multiply(_exp_q(d_mw), prob.mount_q),
            mount_t=prob.mount_t + d_mt)
    return out


def _project(prob: RigBAProblem):
    """(residuals (2N,), the terms of their Jacobian): each observation's
    rig-frame and camera-frame point and projection."""
    qs, ts = prob.rig_q[prob.snap_idx], prob.rig_t[prob.snap_idx]
    qc, tc = prob.mount_q[prob.cam_idx], prob.mount_t[prob.cam_idx]
    X = prob.points[prob.pt_idx]
    v_s = rops.quat_rotate(qs, X)                 # R_s X
    v_c = rops.quat_rotate(qc, v_s + ts)          # R_c x_rig
    x_cam = v_c + tc
    z = x_cam[:, 2]
    clamped = torch.abs(z) < 1e-9
    z = torch.where(clamped, torch.full_like(z, 1e-9), z)
    uv = x_cam[:, :2] / z[:, None]
    f = prob.focal[prob.cam_idx]
    r = (uv * f[:, None] + prob.pp[prob.cam_idx] - prob.obs_xy).reshape(-1)
    return r, (qs, qc, v_s, v_c, uv, z, clamped, f)


def _cost(r: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(r * r)


def _jacobian(prob: RigBAProblem, terms: tuple,
              free: torch.Tensor) -> torch.Tensor:
    """The dense (2N, 6S + 6C + 3P) Jacobian at the problem's parameters
    (a zero increment), its pinned columns zero."""
    qs, qc, v_s, v_c, uv, z, clamped, f = terms
    S, C, P = prob.rig_q.shape[0], prob.mount_q.shape[0], \
        prob.points.shape[0]
    N = v_s.shape[0]
    # d pixel / d camera-frame point (N, 2, 3); the clamped depth is a
    # constant, as jnp.where's derivative makes it
    fz = (f / z)[:, None]
    dz = torch.where(clamped[:, None], torch.zeros_like(uv), -fz * uv)
    zero = torch.zeros_like(fz[:, 0])
    Jp = torch.stack([torch.stack([fz[:, 0], zero, dz[:, 0]], -1),
                      torch.stack([zero, fz[:, 0], dz[:, 1]], -1)], -2)
    Rc = rops.quat_to_rotmat(qc)
    JpRc = Jp @ Rc
    # d(R(w) v)/dw at w = 0 is -[v]x
    blocks = torch.cat([
        JpRc @ -rops.skew(v_s), JpRc,                     # rig w, rig t
        Jp @ -rops.skew(v_c), Jp,                         # mount w, mount t
        JpRc @ rops.quat_to_rotmat(qs)], -1)              # point
    k3 = torch.arange(3, device=z.device)
    starts = torch.stack([
        3 * prob.snap_idx, 3 * S + 3 * prob.snap_idx,
        6 * S + 3 * prob.cam_idx, 6 * S + 3 * C + 3 * prob.cam_idx,
        6 * S + 6 * C + 3 * prob.pt_idx], -1).long()
    cols = (starts[:, :, None] + k3).reshape(N, 15)
    blocks = blocks * free[cols][:, None, :]
    J = torch.zeros((N, 2, 6 * S + 6 * C + 3 * P), dtype=z.dtype,
                    device=z.device)
    J.scatter_(2, cols[:, None, :].expand(N, 2, 15), blocks)
    return J.reshape(2 * N, -1)


def gauge_mask(S: int, C: int, P: int, refine_relative_poses: bool,
               device) -> torch.Tensor:
    """Free parameters: all but snapshot 0's rig pose and mount 0 (and
    every mount unless the relative poses are refined)."""
    free = torch.ones(6 * S + 6 * C + 3 * P, dtype=torch.bool,
                      device=device)
    free[:3] = False
    free[3 * S:3 * S + 3] = False
    free[6 * S:6 * S + 3] = False
    free[6 * S + 3 * C:6 * S + 3 * C + 3] = False
    if not refine_relative_poses:
        free[6 * S:6 * S + 6 * C] = False
    return free


def solve(prob: RigBAProblem,
          opts: RigBAOptions = RigBAOptions()) -> RigBAResult:
    """LM on the device of `prob`, gauge fixed by snapshot 0 and mount 0."""
    S, C, P = prob.rig_q.shape[0], prob.mount_q.shape[0], \
        prob.points.shape[0]
    refine = opts.refine_relative_poses
    dev, dt = prob.points.device, prob.points.dtype
    free = gauge_mask(S, C, P, refine, dev)
    freef = free.to(dt)
    pinned = torch.diag((~free).to(dt))
    lam = torch.tensor(opts.lam0, dtype=dt, device=dev)
    r, terms = _project(prob)
    c0 = _cost(r)
    p = prob
    for _ in range(opts.max_iterations):
        J = _jacobian(p, terms, free)
        H = J.T @ J
        g = J.T @ r
        Hl = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-6))
        Hl = Hl + pinned
        step = -torch.linalg.solve(Hl, g) * freef
        del J, H, Hl
        p_new = _apply(p, step, refine)
        r_new, terms_new = _project(p_new)
        accept = _cost(r_new) < _cost(r)
        p = p._replace(**{k: torch.where(accept, getattr(p_new, k),
                                         getattr(p, k)) for k in _PARAMS})
        r = torch.where(accept, r_new, r)
        terms = tuple(torch.where(accept, a, b)
                      for a, b in zip(terms_new, terms))
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return RigBAResult(p.rig_q, p.rig_t, p.mount_q, p.mount_t, p.points,
                       c0, _cost(r))
