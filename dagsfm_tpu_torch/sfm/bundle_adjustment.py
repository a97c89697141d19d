"""Bundle adjustment: Schur-complement Levenberg-Marquardt, dense solve.

Port of the dense, non-joint, pinhole path of
dagsfm_tpu/sfm/bundle_adjustment.py:
  * `make_problem` keeps the reference's observation set exactly: tracks
    longer than max_track_len are decimated uniformly with the per-track
    Knuth-hash phase; everything else about the layout is the port's own
    (observations stay in their order, compacted to the kept ones).
  * residuals r_n = project(cam_{i(n)}, X_{p(n)}) - obs_n with analytic
    Jacobians of the local (so(3) left increment, translation, point)
    update; Cauchy / Huber / trivial loss as IRLS weights.
  * the reduced camera system S = U - W V^-1 Wᵀ is assembled by segment
    sums over the observation pairs that share a point (one GPU-natural
    assembly in place of the reference's three XLA modes), then solved
    by a dense Cholesky. Every per-camera and per-point sum adds its
    terms in a fixed order (`_segment_sum`): `index_add_`'s atomics on a
    GPU add in no fixed order, and a mapping then differed from run to
    run in its last bits.
  * the LM loop keeps the reference's accept/reject rule, lambda
    schedule (/3 on accept, x4 on reject, in [1e-10, 1e6]) and its exit
    on two consecutive accepted steps with relative gain below ftol, or
    a rejection at the lambda ceiling.
The iterative PCG solver and joint intrinsics refinement wait.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch.device import DTYPE
from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.ops import solve as lin
from dagsfm_tpu_torch.scene import cameras as cm


class Segments(NamedTuple):
    """Rows of a tensor grouped by target: rows `order` (None: the rows
    as they are) fall into consecutive runs of `lengths`, one run per
    target in target order, each run in the rows' original order."""
    order: torch.Tensor | None  # (M,) int64
    lengths: torch.Tensor       # (T,) int64


class BAProblem(NamedTuple):
    """I images, P points, N kept observations, C cameras, Q observation
    pairs that share a point (the S blocks), sorted by their S block."""
    image_qvec: torch.Tensor    # (I, 4)
    image_tvec: torch.Tensor    # (I, 3)
    image_camidx: torch.Tensor  # (I,) int64
    cam_model_id: torch.Tensor  # (C,) int64
    cam_params: torch.Tensor    # (C, 12)
    points: torch.Tensor        # (P, 3)
    obs_image: torch.Tensor     # (N,) int64
    obs_point: torch.Tensor     # (N,) int64
    obs_xy: torch.Tensor        # (N, 2)
    pair_a: torch.Tensor        # (Q,) obs index
    pair_b: torch.Tensor        # (Q,) obs index of the same point
    by_image: Segments          # observations per image
    by_point: Segments          # observations per point
    by_block: Segments          # pairs per S block image(a) * I + image(b)
    const_image: torch.Tensor   # (I,) bool
    const_points: torch.Tensor  # (P,) bool
    cam_refine: torch.Tensor    # (C, 8); must be zero in this port


class BAOptions(NamedTuple):
    max_iterations: int = 30
    loss: str = "cauchy"            # 'trivial' | 'huber' | 'cauchy'
    loss_scale: float = 1.0         # pixels
    init_lambda: float = 1e-4
    refine_focal: bool = False
    refine_principal: bool = False
    refine_extra: bool = False
    point_damping: float = 1e-8
    solver: str = "auto"            # only the dense solver is ported
    dense_threshold: int = 250
    ftol: float = 1e-6


class BAStats(NamedTuple):
    initial_cost: float
    final_cost: float
    num_iterations: int
    lam: float


def all_pinhole(arrays) -> bool:
    mids = np.asarray(torch.as_tensor(arrays.cam_model_id).cpu())
    return bool(np.isin(mids, cm.PINHOLE_MODELS).all())


def kept_observations(obs_point, obs_mask, num_points: int,
                      max_track_len: int = 16) -> np.ndarray:
    """(N,) bool: the observations the reference's make_problem keeps.

    A track longer than T = max_track_len keeps T observations spread
    uniformly along it, with a per-track phase from a Knuth hash of the
    point id so that the kept views rotate across tracks."""
    op = np.asarray(obs_point).astype(np.int64)
    om = np.asarray(obs_mask).astype(bool)
    N, P = len(op), num_points
    if om.any():
        actual = int(np.bincount(op[om], minlength=P).max())
        max_track_len = min(max_track_len, max(4, -(-actual // 4) * 4))
    T = max_track_len
    live0 = np.nonzero(om)[0]
    sorted_n = live0[np.argsort(op[live0], kind="stable")]
    sorted_p = op[sorted_n]
    starts = np.searchsorted(sorted_p, np.arange(P))
    sizes = np.bincount(sorted_p, minlength=P)
    pos = np.arange(len(sorted_n)) - starts[sorted_p]
    sz = sizes[sorted_p]
    szc = np.maximum(sz, 1)
    phase = (sorted_p.astype(np.int64) * 2654435761) % szc
    posr = (pos + phase) % szc
    keep = (posr * T) // szc != ((posr + 1) * T) // szc
    keep |= sz <= T
    slot = np.where(sz <= T, pos, (posr * T) // szc)
    fits = keep & (slot < T)
    kept = np.zeros(N, bool)
    kept[sorted_n[fits]] = True
    return kept & om


def _point_pairs(obs_point: np.ndarray, num_points: int):
    """All ordered (a, b) observation pairs of a common point."""
    order = np.argsort(obs_point, kind="stable")
    sp = obs_point[order]
    sizes = np.bincount(sp, minlength=num_points)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rep = sizes[sp]
    total = int(rep.sum())
    first = np.repeat(np.cumsum(rep) - rep, rep)
    offs = np.arange(total) - first
    pa = np.repeat(order, rep)
    pb = order[np.repeat(starts[sp], rep) + offs]
    return pa, pb


def make_problem(arrays, max_track_len: int = 16, const_image=None,
                 const_points=None, cam_refine=None) -> BAProblem:
    """BAProblem on the device of `arrays` (a SceneArrays)."""
    dev = arrays.image_qvec.device
    op = arrays.obs_point.cpu().numpy().astype(np.int64)
    oi = arrays.obs_image.cpu().numpy().astype(np.int64)
    P = arrays.points_xyz.shape[0]
    I = arrays.image_qvec.shape[0]
    C = arrays.cam_params.shape[0]
    kept = np.nonzero(kept_observations(
        op, arrays.obs_mask.cpu().numpy(), P, max_track_len))[0]
    op, oi = op[kept], oi[kept]
    pa, pb = _point_pairs(op, P)
    block = oi[pa] * I + oi[pb]
    by_block = np.argsort(block, kind="stable")
    pa, pb = pa[by_block], pb[by_block]
    if const_image is None:
        const_image = np.zeros(I, bool)
    if const_points is None:
        const_points = np.zeros(P, bool)
    if cam_refine is None:
        cam_refine = np.zeros((C, cm.NUM_INTRINSIC_SLOTS))

    def lt(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    def bt(a):
        return torch.as_tensor(np.asarray(a, bool), device=dev)

    def seg(keys, num, order=True):
        return Segments(lt(np.argsort(keys, kind="stable")) if order
                        else None, lt(np.bincount(keys, minlength=num)))

    return BAProblem(
        arrays.image_qvec.to(DTYPE), arrays.image_tvec.to(DTYPE),
        arrays.image_camidx.long(), arrays.cam_model_id.long(),
        arrays.cam_params.to(DTYPE), arrays.points_xyz.to(DTYPE),
        lt(oi), lt(op), arrays.obs_xy.to(DTYPE)[lt(kept)],
        lt(pa), lt(pb), seg(oi, I), seg(op, P),
        seg(block, I * I, order=False), bt(const_image), bt(const_points),
        torch.as_tensor(np.asarray(cam_refine), dtype=DTYPE, device=dev))


def _pinhole_fparams(prob: BAProblem) -> torch.Tensor:
    """(C, 4) = (fx, fy, cx, cy)."""
    return cm.focal_and_pp(prob.cam_model_id, prob.cam_params)


def _project(prob: BAProblem):
    """Per-observation (rotated point R X, camera point Xc, focal params)."""
    oi, op = prob.obs_image, prob.obs_point
    q = prob.image_qvec[oi]
    v = rops.quat_rotate(q, prob.points[op])
    Xc = v + prob.image_tvec[oi]
    f = _pinhole_fparams(prob)[prob.image_camidx][oi]
    return q, v, Xc, f


def _residuals(Xc, f, xy):
    z = Xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    return Xc[:, :2] / zs[:, None] * f[:, :2] + f[:, 2:] - xy, zs


def _residuals_and_jacobians(prob: BAProblem):
    """(r (N,2), Jc (N,2,6), Jp (N,2,3)) at a zero increment.

    Analytic form of the reference's forward-mode Jacobian:
    dXc/dw = -[R X]x, dXc/dt = I, dXc/dX = R; observations behind the
    camera (z < 1e-6) get residual 1e3 and zero Jacobians."""
    q, v, Xc, f = _project(prob)
    r, zs = _residuals(Xc, f, prob.obs_xy)
    bad = Xc[:, 2] < 1e-6
    r = torch.where(bad[:, None], torch.full_like(r, 1e3), r)
    inv = 1.0 / zs
    dz = torch.where(torch.abs(Xc[:, 2]) < 1e-12, torch.zeros_like(zs),
                     -1.0 / (zs * zs))
    zero = torch.zeros_like(zs)
    dP = torch.stack([torch.stack([inv, zero, Xc[:, 0] * dz], -1),
                      torch.stack([zero, inv, Xc[:, 1] * dz], -1)], -2)
    dP = dP * f[:, :2, None]                                  # (N, 2, 3)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(v.shape + (3,))
    Jc = dP @ torch.cat([-rops.skew(v), eye], dim=-1)
    Jp = dP @ rops.quat_to_rotmat(q)
    good = (~bad).to(r.dtype)[:, None, None]
    return r, Jc * good, Jp * good


def _robust_weights(r2, loss: str, scale: float):
    s = r2 / (scale * scale)
    if loss == "trivial":
        return torch.ones_like(r2)
    if loss == "huber":
        return torch.where(s <= 1.0, torch.ones_like(s),
                           1.0 / torch.sqrt(torch.clamp(s, min=1e-18)))
    if loss == "cauchy":
        return 1.0 / (1.0 + s)
    raise ValueError(loss)


def _robust_cost(r2, loss: str, scale: float):
    c2 = scale * scale
    s = r2 / c2
    if loss == "trivial":
        return r2
    if loss == "huber":
        return torch.where(s <= 1.0, r2, c2 * (2.0 * torch.sqrt(
            torch.clamp(s, min=1e-18)) - 1.0))
    if loss == "cauchy":
        return c2 * torch.log1p(s)
    raise ValueError(loss)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    J = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, J], -1)], -2)
    return adj / det[..., None, None]


def _segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """(T, ...) sums of x's rows per target, each run added in row order:
    the same bits on every run, on a GPU too."""
    if seg.order is not None:
        x = x[seg.order]
    return torch.segment_reduce(x, "sum", lengths=seg.lengths, axis=0)


def _build_and_solve(prob: BAProblem, r, Jc, Jp, w, lam: float,
                     opts: BAOptions):
    """One damped Gauss-Newton step via the dense Schur complement.
    Returns (dcam (I, 6), dpt (P, 3))."""
    I = prob.image_qvec.shape[0]
    dt, dev = r.dtype, r.device
    oi, op = prob.obs_image, prob.obs_point
    sw = torch.sqrt(w)[:, None, None]
    free = (~prob.const_image).to(dt)
    Jc_w = Jc * sw * free[oi][:, None, None]
    Jp_w = Jp * sw * (~prob.const_points)[op].to(dt)[:, None, None]
    r_w = r * sw[..., 0]

    JcT, JpT = Jc_w.transpose(1, 2), Jp_w.transpose(1, 2)
    U = _segment_sum(JcT @ Jc_w, prob.by_image)
    V = _segment_sum(JpT @ Jp_w, prob.by_point)
    W = JcT @ Jp_w                                            # (N, 6, 3)
    gc = -_segment_sum((JcT @ r_w[..., None])[..., 0], prob.by_image)
    gp = -_segment_sum((JpT @ r_w[..., None])[..., 0], prob.by_point)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    U = U + lam * eye6 * torch.clamp(U.diagonal(dim1=-2, dim2=-1),
                                     min=1e-6)[..., None]
    Vd = V + (lam * torch.clamp(V.diagonal(dim1=-2, dim2=-1), min=1e-6)[..., None]
              + opts.point_damping) * eye3
    Vinv = _inv3(Vd + 1e-12 * eye3)

    Y = W @ Vinv[op]                                          # (N, 6, 3)
    b = gc - _segment_sum((Y @ gp[op][..., None])[..., 0], prob.by_image)
    S = _segment_sum(-(Y[prob.pair_a] @ W[prob.pair_b].transpose(1, 2)),
                     prob.by_block)
    S = S.reshape(I, I, 6, 6)
    diag = torch.arange(I, device=dev)
    S[diag, diag] += U

    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[diag, diag] += (1.0 - free)[:, None, None] * eye6
    b = b * free[:, None]
    Sfull = S.permute(0, 2, 1, 3).reshape(I * 6, I * 6)
    Sfull = 0.5 * (Sfull + Sfull.T)
    L = lin.cholesky_or_nan(
        Sfull + 1e-10 * torch.eye(I * 6, dtype=dt, device=dev))
    dcam = torch.cholesky_solve(b.reshape(I * 6, 1), L).reshape(I, 6)

    wtd = _segment_sum((W.transpose(1, 2) @ dcam[oi][..., None])[..., 0],
                       prob.by_point)
    dpt = (Vinv @ (gp - wtd)[..., None])[..., 0]
    dpt = dpt * (~prob.const_points)[:, None].to(dt)
    return dcam * free[:, None], dpt


def _apply_step(prob: BAProblem, dcam, dpt) -> BAProblem:
    dq = rops.angleaxis_to_quat(dcam[:, :3])
    q = rops.quat_normalize(rops.quat_multiply(dq, prob.image_qvec))
    return prob._replace(image_qvec=q, image_tvec=prob.image_tvec + dcam[:, 3:],
                         points=prob.points + dpt)


def _plain_cost(prob: BAProblem, opts: BAOptions) -> torch.Tensor:
    _, _, Xc, f = _project(prob)
    r, _ = _residuals(Xc, f, prob.obs_xy)
    r = torch.where((Xc[:, 2] > 1e-6)[:, None], r, torch.full_like(r, 1e3))
    return torch.sum(_robust_cost(torch.sum(r * r, -1), opts.loss,
                                  opts.loss_scale))


compute_cost = _plain_cost


def _check_supported(prob: BAProblem, opts: BAOptions):
    if opts.refine_focal or opts.refine_principal or opts.refine_extra \
            or bool(prob.cam_refine.any()):
        raise NotImplementedError("intrinsics refinement is not ported")
    if not all_pinhole(prob):
        raise NotImplementedError("only pinhole cameras are ported")
    I = prob.image_qvec.shape[0]
    if opts.solver == "iterative" or (opts.solver == "auto"
                                      and I > opts.dense_threshold):
        raise NotImplementedError("the iterative PCG solver is not ported")


def solve(prob: BAProblem, opts: BAOptions = BAOptions(), max_iters=None):
    """LM to convergence. Returns (problem, BAStats).

    As the reference: with an explicit max_iters or ftol > 0 the loop
    exits early on convergence; otherwise it runs all max_iterations."""
    _check_supported(prob, opts)
    bound = opts.max_iterations if max_iters is None else int(max_iters)
    early_exit = max_iters is not None or opts.ftol > 0
    cost = float(_plain_cost(prob, opts))
    init_cost = cost
    lam = float(opts.init_lambda)
    it, small_cnt = 0, 0
    while it < bound:
        r, Jc, Jp = _residuals_and_jacobians(prob)
        w = _robust_weights(torch.sum(r * r, -1), opts.loss, opts.loss_scale)
        dcam, dpt = _build_and_solve(prob, r, Jc, Jp, w, lam, opts)
        trial = _apply_step(prob, dcam, dpt)
        new_cost = float(_plain_cost(trial, opts))
        accept = new_cost < cost
        if accept:
            prob = trial
        rel = (cost - new_cost) / max(cost, 1e-30)
        small_cnt = small_cnt + 1 if (accept and rel < opts.ftol) else 0
        done = small_cnt >= 2 or (not accept and lam >= 1e6)
        if accept:
            cost = new_cost
            lam = max(lam / 3.0, 1e-10)
        else:
            lam = min(lam * 4.0, 1e6)
        it += 1
        if done and early_exit:
            break
    return prob, BAStats(init_cost, cost, it, lam)


def mean_reproj_error_px(prob: BAProblem) -> torch.Tensor:
    """Unrobustified mean reprojection error in pixels."""
    _, _, Xc, f = _project(prob)
    r, _ = _residuals(Xc, f, prob.obs_xy)
    return torch.linalg.norm(r, dim=-1).mean()
