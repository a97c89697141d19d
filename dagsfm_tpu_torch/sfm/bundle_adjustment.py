"""Bundle adjustment: Schur-complement Levenberg-Marquardt.

Port of dagsfm_tpu/sfm/bundle_adjustment.py:
  * `make_problem` keeps the reference's observation set exactly: tracks
    longer than max_track_len are decimated uniformly with the per-track
    Knuth-hash phase; everything else about the layout is the port's own
    (observations stay in their order, compacted to the kept ones).
  * residuals r_n = project(cam_{i(n)}, X_{p(n)}) - obs_n through every
    camera model, with Jacobians of the local (so(3) left increment,
    translation, point) update and, when intrinsics refine, of the
    8-slot intrinsics increment (`cameras.apply_intrinsics_delta`);
    Cauchy / Huber / trivial loss as IRLS weights.
  * two linear solvers, picked as the reference picks them
    (`solver="auto"`: dense up to `dense_threshold` images): the dense
    Schur complement S = U - W V^-1 Wᵀ assembled over the observation
    pairs that share a point and solved by Cholesky, and the reference's
    ITERATIVE_SCHUR: matrix-free PCG on S with the SCHUR_JACOBI
    preconditioner, warm-started from the previous LM step. Each has a
    joint form in which the refinable intrinsics of every camera are
    eliminated together with the poses.
  * every per-camera, per-image and per-point sum adds its terms in a
    fixed order (`_segment_sum`), and the PCG's dot products are plain
    reductions: `index_add_`'s atomics on a GPU add in no fixed order, and
    a mapping then differed from run to run in its last bits.
  * the LM loop keeps the reference's accept/reject rule, lambda
    schedule (/3 on accept, x4 on reject, in [1e-10, 1e6]) and its exit
    on two consecutive accepted steps with relative gain below ftol, or
    a rejection at the lambda ceiling.
The reference's image-major layout, one-hot assemblies and wide
reductions are TPU workarounds; the port computes what they compute with
segment sums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.device import DTYPE
from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.ops import solve as lin
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.utils import observability as obs

# `_segment_sum` adds each run in chunks of at most this many rows, then
# the chunk sums of each target: CUDA's segment_reduce walks a run with
# one thread per output element, and a camera shared by every image
# makes a run of millions of observation pairs
SEGMENT_CHUNK = 256


class Segments(NamedTuple):
    """Rows of a tensor grouped by target: rows `order` (None: the rows
    as they are) fall into consecutive runs of `lengths`, one run per
    target in target order, each run in the rows' original order, and
    each run into `chunk_counts` consecutive `chunks` (an empty run into
    one empty chunk)."""
    order: torch.Tensor | None   # (M,) int64
    lengths: torch.Tensor        # (T,) int64
    chunks: torch.Tensor         # (K,) int64, rows per chunk
    chunk_counts: torch.Tensor   # (T,) int64, chunks per target


def segments(keys, num: int, device, order: bool = True) -> Segments:
    """Segments of the rows by target `keys` (a host int array or a
    tensor) in [0, num), built on `device`: a stable sort by key,
    SEGMENT_CHUNK rows per chunk, one read-back for the number of
    chunks."""
    keys = (keys.to(device, torch.int64) if isinstance(keys, torch.Tensor)
            else torch.as_tensor(np.asarray(keys, np.int64), device=device))
    lengths = torch.bincount(keys, minlength=num)
    ordr = torch.argsort(keys, stable=True) if order else None
    counts = torch.clamp(-(-lengths // SEGMENT_CHUNK), min=1)   # empty: one
    chunks = torch.full((int(counts.sum()),), SEGMENT_CHUNK,
                        dtype=torch.int64, device=device)
    chunks[torch.cumsum(counts, 0) - 1] = \
        lengths - SEGMENT_CHUNK * (counts - 1)
    return Segments(ordr, lengths, chunks, counts)


def _segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """(T, ...) sums of x's rows per target in a fixed order: the same
    bits on every run, on a GPU too. The chunk sums first, then their
    sums per target (empty targets 0)."""
    if seg.order is not None:
        x = x[seg.order]
    part = torch.segment_reduce(x, "sum", lengths=seg.chunks, axis=0)
    return torch.segment_reduce(part, "sum", lengths=seg.chunk_counts,
                                axis=0)


class BAProblem(NamedTuple):
    """I images, P points, N kept observations, C cameras."""
    image_qvec: torch.Tensor    # (I, 4)
    image_tvec: torch.Tensor    # (I, 3)
    image_camidx: torch.Tensor  # (I,) int64
    cam_model_id: torch.Tensor  # (C,) int64
    cam_params: torch.Tensor    # (C, 12)
    points: torch.Tensor        # (P, 3)
    obs_image: torch.Tensor     # (N,) int64
    obs_point: torch.Tensor     # (N,) int64
    obs_cam: torch.Tensor       # (N,) int64, camera of the observation
    obs_xy: torch.Tensor        # (N, 2)
    by_image: Segments          # observations per image
    by_point: Segments          # observations per point
    img_by_cam: Segments        # images per camera
    const_image: torch.Tensor   # (I,) bool
    const_points: torch.Tensor  # (P,) bool
    cam_refine: torch.Tensor    # (C, 8) refinable intrinsic slots
    models: tuple               # the camera model ids present (host)


class BAOptions(NamedTuple):
    max_iterations: int = 30
    loss: str = "cauchy"            # 'trivial' | 'huber' | 'cauchy'
    loss_scale: float = 1.0         # pixels
    init_lambda: float = 1e-4
    # intrinsics refinement switches the joint camera-side system on;
    # which cameras and slots refine is the problem's cam_refine
    refine_focal: bool = False
    refine_principal: bool = False
    refine_extra: bool = False
    point_damping: float = 1e-8
    solver: str = "auto"            # 'dense' | 'iterative' | 'auto'
    dense_threshold: int = 250
    max_linear_iterations: int = 100
    linear_rtol: float = 0.03       # CG stop: |r| <= rtol |b|
    ftol: float = 1e-6


class BAStats(NamedTuple):
    initial_cost: float
    final_cost: float
    num_iterations: int
    lam: float
    cg_iterations: int = 0          # over all LM steps (iterative solver)


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


def problem_from_observations(image_qvec, image_tvec, image_camidx,
                              cam_model_id, cam_params, points, obs_image,
                              obs_point, obs_xy, const_image=None,
                              const_points=None, cam_refine=None,
                              device=None) -> BAProblem:
    """BAProblem from host arrays of exactly the observations to use, on
    `device` (the GPU unless told otherwise)."""
    device = devmod.resolve(device)
    oi = np.asarray(obs_image, np.int64)
    op = np.asarray(obs_point, np.int64)
    camidx = np.asarray(image_camidx, np.int64)
    mids = np.asarray(cam_model_id, np.int64)
    I, P, C = len(camidx), len(np.asarray(points)), len(mids)
    if const_image is None:
        const_image = np.zeros(I, bool)
    if const_points is None:
        const_points = np.zeros(P, bool)
    if cam_refine is None:
        cam_refine = np.zeros((C, cm.NUM_INTRINSIC_SLOTS))

    def ft(a):
        return torch.as_tensor(np.asarray(a), dtype=DTYPE, device=device)

    def lt(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def bt(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return BAProblem(
        ft(image_qvec), ft(image_tvec), lt(camidx), lt(mids), ft(cam_params),
        ft(points), lt(oi), lt(op), lt(camidx[oi]), ft(obs_xy),
        segments(oi, I, device), segments(op, P, device),
        segments(camidx, C, device), bt(const_image), bt(const_points),
        ft(cam_refine), tuple(sorted({int(m) for m in mids})) or (0,))


def make_problem(arrays, max_track_len: int = 16, const_image=None,
                 const_points=None, cam_refine=None) -> BAProblem:
    """BAProblem on the device of `arrays` (a SceneArrays)."""
    op = arrays.obs_point.cpu().numpy().astype(np.int64)
    P = arrays.points_xyz.shape[0]
    kept = np.nonzero(kept_observations(
        op, arrays.obs_mask.cpu().numpy(), P, max_track_len))[0]
    host = (lambda a: a.cpu().numpy())
    return problem_from_observations(
        host(arrays.image_qvec), host(arrays.image_tvec),
        host(arrays.image_camidx), host(arrays.cam_model_id),
        host(arrays.cam_params), host(arrays.points_xyz),
        host(arrays.obs_image)[kept], op[kept], host(arrays.obs_xy)[kept],
        const_image, const_points, cam_refine,
        device=arrays.image_qvec.device)


class Pairs(NamedTuple):
    """Ordered observation pairs (a, b) of a common point, grouped by the
    Schur block they add to: pose-pose (image(a), image(b)) and, for the
    joint system, pose-intrinsics (image(a), camera(b)) and
    intrinsics-intrinsics (camera(a), camera(b))."""
    a: torch.Tensor
    b: torch.Tensor
    by_pp: Segments
    by_pg: Segments | None
    by_gg: Segments | None


def _pairs(prob: BAProblem, joint: bool) -> Pairs:
    op = prob.obs_point.cpu().numpy()
    oi = prob.obs_image.cpu().numpy()
    oc = prob.obs_cam.cpu().numpy()
    P = prob.points.shape[0]
    I, C = prob.image_qvec.shape[0], prob.cam_params.shape[0]
    order = np.argsort(op, kind="stable")
    sp = op[order]
    sizes = np.bincount(sp, minlength=P)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rep = sizes[sp]
    first = np.repeat(np.cumsum(rep) - rep, rep)
    offs = np.arange(int(rep.sum())) - first
    pa = np.repeat(order, rep)
    pb = order[np.repeat(starts[sp], rep) + offs]
    dev = prob.obs_point.device
    lt = (lambda a: torch.as_tensor(a, device=dev))
    by_pg = by_gg = None
    if joint:
        by_pg = segments(oi[pa] * C + oc[pb], I * C, dev)
        by_gg = segments(oc[pa] * C + oc[pb], C * C, dev)
    return Pairs(lt(pa), lt(pb), segments(oi[pa] * I + oi[pb], I * I, dev),
                 by_pg, by_gg)


def _project(prob: BAProblem):
    """Per-observation (rotation q, rotated point R X, camera point Xc,
    model ids, padded params)."""
    oi, op = prob.obs_image, prob.obs_point
    q = prob.image_qvec[oi]
    v = rops.quat_rotate(q, prob.points[op])
    Xc = v + prob.image_tvec[oi]
    return (q, v, Xc, prob.cam_model_id[prob.obs_cam],
            prob.cam_params[prob.obs_cam])


def _residuals_and_jacobians(prob: BAProblem, refine_int: bool = False):
    """(r (N,2), Jc (N,2,6), Jp (N,2,3), Jg (N,2,8) or None) at a zero
    increment.

    The chain of the reference's forward-mode Jacobian: pixels = f ·
    distort(Xc[:2] / z) + pp, with dXc/dw = -[R X]x, dXc/dt = I,
    dXc/dX = R and distort's 2x2 Jacobian from `cameras`. Jg is the
    8-slot intrinsics increment's (slot 0 = f · d/df, as the log-focal
    increment gives it), masked by the camera's cam_refine row.
    Observations behind the camera (z < 1e-6) get residual 1e3 and zero
    Jacobians."""
    q, v, Xc, mid, par = _project(prob)
    z = Xc[:, 2]
    clamped = torch.abs(z) < 1e-12
    zs = torch.where(clamped, torch.full_like(z, 1e-12), z)
    uvn = Xc[:, :2] / zs[:, None]
    out = cm.distort_jacobians(mid, par, uvn, wrt_extra=refine_int,
                               models=prob.models)
    d, Jd = out[0], out[1]
    f = cm.focal_and_pp(mid, par)
    r = d * f[:, :2] + f[:, 2:] - prob.obs_xy
    bad = Xc[:, 2] < 1e-6
    r = torch.where(bad[:, None], torch.full_like(r, 1e3), r)
    inv = 1.0 / zs
    dz = torch.where(clamped, torch.zeros_like(zs), -1.0 / (zs * zs))
    zero = torch.zeros_like(zs)
    dU = torch.stack([torch.stack([inv, zero, Xc[:, 0] * dz], -1),
                      torch.stack([zero, inv, Xc[:, 1] * dz], -1)], -2)
    dP = (Jd @ dU) * f[:, :2, None]                           # (N, 2, 3)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(v.shape + (3,))
    good = (~bad).to(r.dtype)[:, None, None]
    Jc = dP @ torch.cat([-rops.skew(v), eye], dim=-1) * good
    Jp = dP @ rops.quat_to_rotmat(q) * good
    if not refine_int:
        return r, Jc, Jp, None
    single = cm._is_single_focal(mid)
    fd = f[:, :2] * d                                         # (N, 2)
    one = torch.ones_like(z)
    aspect = torch.stack([zero, torch.where(single, zero, fd[:, 1])], -1)
    Jg = torch.cat([torch.stack([fd, aspect, torch.stack([one, zero], -1),
                                 torch.stack([zero, one], -1)], -1),
                    out[2] * f[:, :2, None]], -1)             # (N, 2, 8)
    Jg = Jg * good * prob.cam_refine[prob.obs_cam][:, None, :]
    return r, Jc, Jp, Jg


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


def _damp(U: torch.Tensor, lam: float) -> torch.Tensor:
    """Levenberg damping: lam · max(diag, 1e-6) added to the diagonal."""
    eye = torch.eye(U.shape[-1], dtype=U.dtype, device=U.device)
    return U + lam * eye * torch.clamp(U.diagonal(dim1=-2, dim2=-1),
                                       min=1e-6)[..., None]


def _point_blocks(prob: BAProblem, r_w, Jp_w, lam: float, opts: BAOptions):
    """(gp (P,3), Vinv (P,3,3)): the point side, damped and inverted."""
    JpT = Jp_w.transpose(1, 2)
    V = _segment_sum(JpT @ Jp_w, prob.by_point)
    gp = -_segment_sum((JpT @ r_w[..., None])[..., 0], prob.by_point)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Vd = V + (lam * torch.clamp(V.diagonal(dim1=-2, dim2=-1), min=1e-6)[
        ..., None] + opts.point_damping) * eye3
    return gp, _inv3(Vd + 1e-12 * eye3)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def _mtv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def _spd_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetrised, regularised Cholesky solve (NaN if not SPD)."""
    S = 0.5 * (S + S.T)
    L = lin.cholesky_or_nan(
        S + 1e-10 * torch.eye(S.shape[0], dtype=S.dtype, device=S.device))
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def _solve_dense(prob: BAProblem, pairs: Pairs, r_w, Jc_w, Jp_w, lam: float,
                 opts: BAOptions):
    """Dense Schur step. Returns (dcam (I, 6), dpt (P, 3))."""
    I = prob.image_qvec.shape[0]
    dt, dev = r_w.dtype, r_w.device
    oi, op = prob.obs_image, prob.obs_point
    free = (~prob.const_image).to(dt)
    JcT = Jc_w.transpose(1, 2)
    U = _damp(_segment_sum(JcT @ Jc_w, prob.by_image), lam)
    gc = -_segment_sum((JcT @ r_w[..., None])[..., 0], prob.by_image)
    gp, Vinv = _point_blocks(prob, r_w, Jp_w, lam, opts)
    W = JcT @ Jp_w                                            # (N, 6, 3)
    Y = W @ Vinv[op]
    b = gc - _segment_sum(_mv(Y, gp[op]), prob.by_image)
    S = _segment_sum(-(Y[pairs.a] @ W[pairs.b].transpose(1, 2)),
                     pairs.by_pp).reshape(I, I, 6, 6)
    diag = torch.arange(I, device=dev)
    S[diag, diag] += U
    eye6 = torch.eye(6, dtype=dt, device=dev)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[diag, diag] += (1.0 - free)[:, None, None] * eye6
    b = b * free[:, None]
    dcam = _spd_solve(S.permute(0, 2, 1, 3).reshape(I * 6, I * 6),
                      b.reshape(-1)).reshape(I, 6)
    wtd = _segment_sum(_mtv(W, dcam[oi]), prob.by_point)
    dpt = _mv(Vinv, gp - wtd) * (~prob.const_points)[:, None].to(dt)
    return dcam * free[:, None], dpt


def _solve_dense_joint(prob: BAProblem, pairs: Pairs, r_w, Jc_w, Jp_w, Jg_w,
                       lam: float, opts: BAOptions):
    """Dense joint Schur step: poses (I, 6) and every camera's intrinsics
    (C, 8) eliminated together, points Schur-eliminated. The intrinsics
    of a camera shared by many images are one block that every
    observation of its images adds to. Returns (dcam, dint, dpt)."""
    I, C = prob.image_qvec.shape[0], prob.cam_params.shape[0]
    G = Jg_w.shape[-1]
    dt, dev = r_w.dtype, r_w.device
    oi, op, oc = prob.obs_image, prob.obs_point, prob.obs_cam

    def fold(z_img):
        return _segment_sum(z_img, prob.img_by_cam)

    JcT, JgT = Jc_w.transpose(1, 2), Jg_w.transpose(1, 2)
    U_pp = _damp(_segment_sum(JcT @ Jc_w, prob.by_image), lam)
    U_gg = _damp(fold(_segment_sum(JgT @ Jg_w, prob.by_image)), lam)
    U_pg = _segment_sum(JcT @ Jg_w, prob.by_image)            # (I, 6, G)
    g_p = -_segment_sum(_mv(JcT, r_w), prob.by_image)
    g_g = -fold(_segment_sum(_mv(JgT, r_w), prob.by_image))
    gp, Vinv = _point_blocks(prob, r_w, Jp_w, lam, opts)
    Wc, Wg = JcT @ Jp_w, JgT @ Jp_w                           # (N, 6|G, 3)
    Vo, gpo = Vinv[op], gp[op]
    Yc, Yg = Wc @ Vo, Wg @ Vo
    g_p = g_p - _segment_sum(_mv(Yc, gpo), prob.by_image)
    g_g = g_g - fold(_segment_sum(_mv(Yg, gpo), prob.by_image))

    pa, pb = pairs.a, pairs.b
    Wc_b, Wg_b = Wc[pb].transpose(1, 2), Wg[pb].transpose(1, 2)
    S_pp = _segment_sum(-(Yc[pa] @ Wc_b), pairs.by_pp).reshape(I, I, 6, 6)
    S_pg = _segment_sum(-(Yc[pa] @ Wg_b), pairs.by_pg).reshape(I, C, 6, G)
    S_gg = _segment_sum(-(Yg[pa] @ Wg_b), pairs.by_gg).reshape(C, C, G, G)
    di, dc = torch.arange(I, device=dev), torch.arange(C, device=dev)
    S_pp[di, di] += U_pp
    S_gg[dc, dc] += U_gg
    S_pg[di, prob.image_camidx] += U_pg

    Spp = S_pp.permute(0, 2, 1, 3).reshape(I * 6, I * 6)
    Spg = S_pg.permute(0, 2, 1, 3).reshape(I * 6, C * G)
    Sgg = S_gg.permute(0, 2, 1, 3).reshape(C * G, C * G)
    S = torch.cat([torch.cat([Spp, Spg], 1), torch.cat([Spg.T, Sgg], 1)], 0)
    b = torch.cat([g_p.reshape(-1), g_g.reshape(-1)])
    free_p = (~prob.const_image).to(dt)
    fv = torch.cat([free_p.repeat_interleave(6),
                    (prob.cam_refine > 0).to(dt).reshape(-1)])
    S = S * fv[:, None] * fv[None, :] + torch.diag(1.0 - fv)
    sol = _spd_solve(S, b * fv) * fv
    dcam = sol[: I * 6].reshape(I, 6)
    dint = sol[I * 6:].reshape(C, G)

    wtd = _segment_sum(_mtv(Wc, dcam[oi]) + _mtv(Wg, dint[oc]),
                       prob.by_point)
    dpt = _mv(Vinv, gp - wtd) * (~prob.const_points)[:, None].to(dt)
    return dcam * free_p[:, None], dint, dpt


def _pcg(S_mv, precond, b: tuple, x0: tuple | None, opts: BAOptions):
    """Preconditioned CG on a system of several blocks (tuples of
    tensors), from x0 (None: zero), stopping at |r| <= linear_rtol |b| or
    after max_linear_iterations. Returns (x, iterations). The stopping
    test reads one boolean to the host before each iteration, and once
    more after the last unless the cap ended the loop."""
    def dot(a, c):
        return sum(torch.sum(u * w) for u, w in zip(a, c))

    tol = opts.linear_rtol * torch.clamp(torch.sqrt(dot(b, b)), min=1e-30)
    if x0 is None:
        x, r = tuple(torch.zeros_like(u) for u in b), b
    else:
        x = x0
        r = tuple(u - w for u, w in zip(b, S_mv(*x0)))
    z = precond(*r)
    p, rz = z, dot(r, z)
    k = 0
    while k < opts.max_linear_iterations and \
            obs.host_read(torch.sqrt(dot(r, r)) > tol, bool):
        Ap = S_mv(*p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-30, 1e-30, pAp)
        x = tuple(u + alpha * w for u, w in zip(x, p))
        r = tuple(u - alpha * w for u, w in zip(r, Ap))
        z = precond(*r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-30, 1e-30, rz)
        p = tuple(u + beta * w for u, w in zip(z, p))
        rz = rz_new
        k += 1
    return x, k


def _block_inverse(S: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """SCHUR_JACOBI: the inverse of each diagonal block, pinned rows and
    columns (free = 0) replaced by the identity's."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    S = S * (free[..., :, None] * free[..., None, :]) + \
        (1.0 - free)[..., :, None] * eye
    S = 0.5 * (S + S.transpose(-1, -2)) + 1e-10 * eye
    return lin.solve_or_nan(S, eye.expand(S.shape))


def _no_reduce(*xs):
    return xs


def _solve_iterative(prob: BAProblem, r_w, Jc_w, Jp_w, lam: float,
                     opts: BAOptions, x_init, reduce=_no_reduce):
    """ITERATIVE_SCHUR: SCHUR_JACOBI-preconditioned CG on the reduced
    camera system, S·x = U x - W V⁻¹ Wᵀ x never formed, from x_init
    (None: zero). `reduce` sums per-image blocks over the processes that
    hold the other observations (the sharded solve; one call before the
    CG and one per CG iteration). Returns (dcam, dpt, CG iterations)."""
    dt = r_w.dtype
    oi, op = prob.obs_image, prob.obs_point
    free = (~prob.const_image).to(dt)[:, None]
    JcT = Jc_w.transpose(1, 2)
    gp, Vinv = _point_blocks(prob, r_w, Jp_w, lam, opts)
    W = JcT @ Jp_w
    WVinv = W @ Vinv[op]
    U, gc, corr, B = reduce(
        _segment_sum(JcT @ Jc_w, prob.by_image),
        _segment_sum(_mv(JcT, r_w), prob.by_image),
        _segment_sum(_mv(W, _mv(Vinv, gp)[op]), prob.by_image),
        _segment_sum(WVinv @ W.transpose(1, 2), prob.by_image))
    Ud = _damp(U, lam)
    b = (-gc - corr) * free
    Minv = _block_inverse(Ud - B, free.expand(-1, 6))

    def S_mv(x):
        xm = x * free
        y = _mv(Vinv, _segment_sum(_mtv(W, xm[oi]), prob.by_point))
        z, = reduce(_segment_sum(_mv(W, y[op]), prob.by_image))
        Sx = _mv(Ud, xm) - z
        return (Sx * free + x * (1.0 - free),)

    with obs.span("ba.pcg"):
        (dcam,), k = _pcg(S_mv, lambda v: (_mv(Minv, v),), (b,),
                          None if x_init is None else (x_init * free,), opts)
    dcam = dcam * free
    wtd = _segment_sum(_mtv(W, dcam[oi]), prob.by_point)
    dpt = _mv(Vinv, gp - wtd) * (~prob.const_points)[:, None].to(dt)
    return dcam, dpt, k


def _solve_iterative_joint(prob: BAProblem, r_w, Jc_w, Jp_w, Jg_w,
                           lam: float, opts: BAOptions, x_init,
                           reduce=_no_reduce):
    """ITERATIVE_SCHUR with intrinsics: PCG on the joint camera-side
    system, its SCHUR_JACOBI preconditioner the pose blocks and the
    intrinsics blocks (their coupling dropped from the preconditioner
    only). CG starts from x_init's poses (None: zero) and zero
    intrinsics, as the reference. `reduce` as in `_solve_iterative`: the
    per-image blocks are summed over processes before they are folded
    into cameras. Returns (dcam, dint, dpt, CG iterations)."""
    dt = r_w.dtype
    oi, op, oc = prob.obs_image, prob.obs_point, prob.obs_cam
    camidx = prob.image_camidx
    free = (~prob.const_image).to(dt)[:, None]
    gfree = (prob.cam_refine > 0).to(dt)                     # (C, G)

    def fold(z_img):
        return _segment_sum(z_img, prob.img_by_cam)

    JcT, JgT = Jc_w.transpose(1, 2), Jg_w.transpose(1, 2)
    gp, Vinv = _point_blocks(prob, r_w, Jp_w, lam, opts)
    Wc, Wg = JcT @ Jp_w, JgT @ Jp_w
    Vo, gpo = Vinv[op], gp[op]
    WcVinv, WgVinv = Wc @ Vo, Wg @ Vo
    U_pp, U_gg, U_pg, gc, gg, corr_p, corr_g, B_p, B_g = reduce(*(
        _segment_sum(x, prob.by_image) for x in (
            JcT @ Jc_w, JgT @ Jg_w, JcT @ Jg_w, _mv(JcT, r_w),
            _mv(JgT, r_w), _mv(WcVinv, gpo), _mv(WgVinv, gpo),
            WcVinv @ Wc.transpose(1, 2), WgVinv @ Wg.transpose(1, 2))))
    U_ppd = _damp(U_pp, lam)
    U_ggd = _damp(fold(U_gg), lam)                           # (C, G, G)
    b_p = (-gc - corr_p) * free
    b_g = (-fold(gg) - fold(corr_g)) * gfree
    Minv_p = _block_inverse(U_ppd - B_p, free.expand(-1, 6))
    Minv_g = _block_inverse(U_ggd - fold(B_g), gfree)

    def S_mv(xp, xg):
        xpm, xgm = xp * free, xg * gfree
        tmp = _segment_sum(_mtv(Wc, xpm[oi]) + _mtv(Wg, xgm[oc]),
                           prob.by_point)
        yo = _mv(Vinv, tmp)[op]
        zc, zg = reduce(_segment_sum(_mv(Wc, yo), prob.by_image),
                        _segment_sum(_mv(Wg, yo), prob.by_image))
        Sxp = _mv(U_ppd, xpm) + _mv(U_pg, xgm[camidx]) - zc
        Sxg = _mv(U_ggd, xgm) + fold(_mtv(U_pg, xpm)) - fold(zg)
        return (Sxp * free + xp * (1.0 - free),
                Sxg * gfree + xg * (1.0 - gfree))

    with obs.span("ba.pcg"):
        (dcam, dint), k = _pcg(
            S_mv, lambda vp, vg: (_mv(Minv_p, vp), _mv(Minv_g, vg)),
            (b_p, b_g),
            None if x_init is None else (x_init * free,
                                         torch.zeros_like(b_g)), opts)
    dcam, dint = dcam * free, dint * gfree
    wtd = _segment_sum(_mtv(Wc, dcam[oi]) + _mtv(Wg, dint[oc]),
                       prob.by_point)
    dpt = _mv(Vinv, gp - wtd) * (~prob.const_points)[:, None].to(dt)
    return dcam, dint, dpt, k


def _build_and_solve(prob: BAProblem, pairs: Pairs | None, r, Jc, Jp, Jg, w,
                     lam: float, opts: BAOptions, x_init):
    """One damped Gauss-Newton step. Returns (dcam (I, 6), dint (C, 8) or
    None, dpt (P, 3), CG iterations)."""
    dt = r.dtype
    sw = torch.sqrt(w)[:, None, None]
    # a pinned image's observations still constrain its points and its
    # camera's intrinsics; only its pose Jacobian vanishes
    Jc_w = Jc * sw * (~prob.const_image).to(dt)[prob.obs_image][:, None, None]
    Jp_w = Jp * sw * (~prob.const_points).to(dt)[prob.obs_point][:, None,
                                                                 None]
    r_w = r * sw[..., 0]
    if pairs is None:
        if Jg is not None:
            return _solve_iterative_joint(prob, r_w, Jc_w, Jp_w, Jg * sw,
                                          lam, opts, x_init)
        dcam, dpt, k = _solve_iterative(prob, r_w, Jc_w, Jp_w, lam, opts,
                                        x_init)
        return dcam, None, dpt, k
    if Jg is not None:
        return _solve_dense_joint(prob, pairs, r_w, Jc_w, Jp_w, Jg * sw,
                                  lam, opts) + (0,)
    dcam, dpt = _solve_dense(prob, pairs, r_w, Jc_w, Jp_w, lam, opts)
    return dcam, None, dpt, 0


def _apply_step(prob: BAProblem, dcam, dpt, dint=None) -> BAProblem:
    dq = rops.angleaxis_to_quat(dcam[:, :3])
    q = rops.quat_normalize(rops.quat_multiply(dq, prob.image_qvec))
    out = prob._replace(image_qvec=q, image_tvec=prob.image_tvec + dcam[:, 3:],
                        points=prob.points + dpt)
    if dint is not None:
        out = out._replace(cam_params=cm.apply_intrinsics_delta(
            prob.cam_model_id, prob.cam_params, dint * prob.cam_refine))
    return out


def _reprojection(prob: BAProblem):
    """(pixel residuals (N, 2), depths (N,))."""
    _, _, Xc, mid, par = _project(prob)
    return cm.img_from_cam(mid, par, Xc, prob.models) - prob.obs_xy, Xc[:, 2]


def _plain_cost(prob: BAProblem, opts: BAOptions) -> torch.Tensor:
    r, z = _reprojection(prob)
    r = torch.where((z > 1e-6)[:, None], r, torch.full_like(r, 1e3))
    return torch.sum(_robust_cost(torch.sum(r * r, -1), opts.loss,
                                  opts.loss_scale))


compute_cost = _plain_cost


def _refine_any(opts: BAOptions) -> bool:
    return opts.refine_focal or opts.refine_principal or opts.refine_extra


def solve(prob: BAProblem, opts: BAOptions = BAOptions(), max_iters=None):
    """LM to convergence. Returns (problem, BAStats).

    As the reference: with an explicit max_iters or ftol > 0 the loop
    exits early on convergence; otherwise it runs all max_iterations.
    The iterative solver's CG starts from the previous LM step's pose
    increment, accepted or not. One span, `ba.solve`, counting its
    `lm_steps`; each step's `ba.linearize`, `ba.solve_step` (with
    `ba.pcg`) and `ba.evaluate` inside it."""
    with obs.span("ba.solve"):
        prob, stats = _solve(prob, opts, max_iters)
        obs.count("lm_steps", stats.num_iterations)
    return prob, stats


def _solve(prob: BAProblem, opts: BAOptions, max_iters):
    refine = _refine_any(opts)
    I = prob.image_qvec.shape[0]
    solver = opts.solver
    if solver == "auto":
        solver = "iterative" if I > opts.dense_threshold else "dense"
    if solver not in ("dense", "iterative"):
        raise ValueError(f"unknown solver {opts.solver!r}")
    pairs = _pairs(prob, refine) if solver == "dense" else None
    bound = opts.max_iterations if max_iters is None else int(max_iters)
    early_exit = max_iters is not None or opts.ftol > 0
    cost = obs.host_read(_plain_cost(prob, opts), float)
    init_cost = cost
    lam = float(opts.init_lambda)
    it, small_cnt, cg = 0, 0, 0
    dprev = prob.image_tvec.new_zeros((I, 6))
    while it < bound:
        with obs.span("ba.linearize"):
            r, Jc, Jp, Jg = _residuals_and_jacobians(prob, refine)
            w = _robust_weights(torch.sum(r * r, -1), opts.loss,
                                opts.loss_scale)
        with obs.span("ba.solve_step"):
            dcam, dint, dpt, k = _build_and_solve(prob, pairs, r, Jc, Jp, Jg,
                                                  w, lam, opts, dprev)
        cg += k
        with obs.span("ba.evaluate"):
            trial = _apply_step(prob, dcam, dpt, dint)
            new_cost = obs.host_read(_plain_cost(trial, opts), float)
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
        dprev = dcam
        it += 1
        if done and early_exit:
            break
    return prob, BAStats(init_cost, cost, it, lam, cg)


def mean_reproj_error_px(prob: BAProblem) -> torch.Tensor:
    """Unrobustified mean reprojection error in pixels."""
    r, _ = _reprojection(prob)
    return torch.linalg.norm(r, dim=-1).mean()
