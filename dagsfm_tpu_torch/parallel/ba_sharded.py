"""Schur-complement bundle adjustment with the points cut into shards.

Port of dagsfm_tpu/parallel/ba_sharded.py. `shard_problem` cuts a scene
into the reference's D shards by point, arrays equal to its own: every
track lives wholly in one shard, so the point blocks V, the point
gradient and the back-substitution never leave their shard. Shard d
lives on rank d % W of the process group (`parallel.mesh`); a rank
solves the union of its shards as one local problem, sums its per-image
blocks and makes one `all_reduce` where the reference makes one `psum`:
  * dense: (S, gc, corr) once per LM iteration; S's diagonal is damped
    after the reduce, as the reference damps it;
  * iterative (matrix-free SCHUR_JACOBI PCG): (U, gc, corr, diagonal
    blocks) once per LM iteration, then one (I, 6) reduce per CG
    iteration, CG starting from zero;
  * joint with the intrinsics (forced when any refines): the image-level
    intrinsics blocks ride the same reduces and are folded into cameras
    after them;
  * the cost: one scalar per evaluation.
The reduced camera system is solved on every rank alike, so every rank
takes the same LM decisions. On cards the group is NCCL's, one rank a
card (`mesh.init_ranks`), and every tensor of a rank lives on its card.

The solver's rules are the reference's sharded solver's, not those of
`sfm.bundle_adjustment.solve`: tracks longer than max_track_len are
decimated uniformly (slots (pos T) // size, no hash phase); the loss is
Cauchy of scale loss_scale whatever `opts.loss`; exactly
max_iterations LM iterations, no ftol exit, lambda max(lambda/3, 1e-10)
on accept and min(4 lambda, 1e6) on reject; `solver="auto"` takes the
iterative regime above dense_threshold images. Those rules, and the dense
step's damping of S after the reduce, are why the LM loop and the dense
step here are the module's own; the weighting, the solver choice and the
iterative step are `sfm.bundle_adjustment`'s.

The reference's `place` and its compiled-program cache (`_cached_solver`)
are XLA's concerns and have no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.device import DTYPE
from dagsfm_tpu_torch.ops.segment_sum import mtv, mv, segment_sum
from dagsfm_tpu_torch.parallel.mesh import (all_reduce, all_reduce_many,
                                            own_shards, partition_balanced)
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
from dagsfm_tpu_torch.utils import observability as obs


class ShardedBAProblem(NamedTuple):
    """BA problem with point/observation data cut into D shards; the
    reference's fields, dtypes and layout. Leading axis D on the sharded
    fields; the others are the same for every shard."""
    image_qvec: torch.Tensor     # (I, 4)
    image_tvec: torch.Tensor     # (I, 3)
    image_camidx: torch.Tensor   # (I,) int32
    cam_model_id: torch.Tensor   # (C,) int32
    cam_params: torch.Tensor     # (C, MAX)
    const_image: torch.Tensor    # (I,) bool
    cam_refine: torch.Tensor     # (C, 8) refinable intrinsic slots
    points: torch.Tensor         # (D, Pd, 3)
    points_mask: torch.Tensor    # (D, Pd)
    obs_image: torch.Tensor      # (D, Nd) int32
    obs_point: torch.Tensor      # (D, Nd) int32, point index within shard
    obs_xy: torch.Tensor         # (D, Nd, 2)
    obs_mask: torch.Tensor       # (D, Nd), kept observations
    trk_obs: torch.Tensor        # (D, Pd, T) int32, obs index within shard
    trk_mask: torch.Tensor       # (D, Pd, T)
    cam_obs: torch.Tensor        # (D, I, Ml) int32, obs index within shard
    cam_mask: torch.Tensor       # (D, I, Ml)


def _bucket(n: int, m: int) -> int:
    b = m
    while b < n:
        b *= 2
    return b


def shard_arrays(arrays: dict, num_devices: int,
                 max_track_len: int = 16) -> tuple:
    """The reference's shard layout in numpy: (dict of the sharded
    fields, shard_pts). `arrays` holds numpy obs_point, obs_mask,
    obs_image, obs_xy and points_xyz.

    Points are balanced over the shards by track length (largest first);
    (Pd, Nd) are the largest shard's counts in power-of-two buckets (from
    8 and 64); a track longer than T = max_track_len keeps the slots
    (pos T) // size; `cam_obs` groups each shard's kept observations by
    image into Ml slots (a multiple of 8, at least 8)."""
    op, om = arrays["obs_point"], arrays["obs_mask"].astype(bool)
    P_ = arrays["points_xyz"].shape[0]
    tlen = np.bincount(op[om], minlength=P_)
    assign = partition_balanced(np.maximum(tlen, 1), num_devices)
    shard_pts = [np.nonzero(assign == d)[0] for d in range(num_devices)]
    obs_shard = np.full(len(op), -1)
    obs_shard[om] = assign[op[om]]
    obs_by_shard = [np.nonzero(obs_shard == d)[0]
                    for d in range(num_devices)]
    Pd = _bucket(max(len(s) for s in shard_pts), 8)
    Nd = _bucket(max(len(s) for s in obs_by_shard), 64)

    D, T = num_devices, max_track_len
    I = arrays["image_qvec"].shape[0]
    out = {"points": np.zeros((D, Pd, 3)),
           "points_mask": np.zeros((D, Pd), bool),
           "obs_image": np.zeros((D, Nd), np.int32),
           "obs_point": np.zeros((D, Nd), np.int32),
           "obs_xy": np.zeros((D, Nd, 2)),
           "obs_mask": np.zeros((D, Nd), bool),
           "trk_obs": np.zeros((D, Pd, T), np.int32),
           "trk_mask": np.zeros((D, Pd, T), bool)}
    oi, oxy, xyz = arrays["obs_image"], arrays["obs_xy"], \
        arrays["points_xyz"]
    g2l = np.full(P_, -1, np.int64)
    for d in range(D):
        npts = len(shard_pts[d])
        g2l[shard_pts[d]] = np.arange(npts)
        sel = obs_by_shard[d]
        nloc = len(sel)
        out["points"][d, :npts] = xyz[shard_pts[d]]
        out["points_mask"][d, :npts] = True
        out["obs_image"][d, :nloc] = oi[sel]
        lp = g2l[op[sel]]
        out["obs_point"][d, :nloc] = lp
        out["obs_xy"][d, :nloc] = oxy[sel]
        # track slots: by local point, position within the track; a track
        # longer than T keeps the observations where (pos T) // size
        # steps, in slot (pos T) // size
        order = np.argsort(lp, kind="stable")
        lp_s = lp[order]
        n_s = order.astype(np.int32)
        sizes = np.bincount(lp_s, minlength=Pd)
        starts = np.searchsorted(lp_s, np.arange(Pd))
        pos = np.arange(nloc) - starts[lp_s]
        sz = sizes[lp_s]
        szc = np.maximum(sz, 1)
        keep = (sz <= T) | ((pos * T) // szc != ((pos + 1) * T) // szc)
        slot = np.where(sz <= T, pos, (pos * T) // szc)
        fits = keep & (slot < T)
        out["trk_obs"][d, lp_s[fits], slot[fits]] = n_s[fits]
        out["trk_mask"][d, lp_s[fits], slot[fits]] = True
        live = np.ones(nloc, bool)
        live[n_s[~fits]] = False
        out["obs_mask"][d, :nloc] = live

    Ml = 8
    for d in range(D):
        lv = np.nonzero(out["obs_mask"][d])[0]
        if len(lv):
            c = np.bincount(out["obs_image"][d][lv], minlength=I).max()
            Ml = max(Ml, int(-(-int(c) // 8) * 8))
    out["cam_obs"] = np.zeros((D, I, Ml), np.int32)
    out["cam_mask"] = np.zeros((D, I, Ml), bool)
    for d in range(D):
        lv = np.nonzero(out["obs_mask"][d])[0]
        if not len(lv):
            continue
        im = out["obs_image"][d][lv]
        order = np.argsort(im, kind="stable")
        lv_s, im_s = lv[order], im[order]
        starts = np.searchsorted(im_s, np.arange(I))
        pos = np.arange(len(lv_s)) - starts[im_s]
        out["cam_obs"][d, im_s, pos] = lv_s
        out["cam_mask"][d, im_s, pos] = True
    return out, shard_pts


def shard_problem(arrays, num_devices: int, max_track_len: int = 16,
                  const_image=None, cam_refine=None,
                  device=None) -> tuple:
    """Cut a SceneArrays by point into `num_devices` shards on `device`
    (the GPU unless "cpu" is asked). const_image defaults to the first
    two images pinned, cam_refine to no intrinsics refined. Returns
    (ShardedBAProblem, shard_pts: the global point ids of each shard)."""
    dev = devmod.resolve(device)
    host = {k: np.asarray(torch.as_tensor(v).cpu().numpy())
            for k, v in arrays._asdict().items()}
    sh, shard_pts = shard_arrays(host, num_devices, max_track_len)
    I = host["image_qvec"].shape[0]
    if const_image is None:
        const_image = np.zeros(I, bool)
        const_image[:2] = True
    if cam_refine is None:
        cam_refine = np.zeros((host["cam_params"].shape[0],
                               cm.NUM_INTRINSIC_SLOTS))
    return problem_from_numpy(dict(
        image_qvec=host["image_qvec"], image_tvec=host["image_tvec"],
        image_camidx=host["image_camidx"].astype(np.int32),
        cam_model_id=host["cam_model_id"].astype(np.int32),
        cam_params=host["cam_params"], const_image=np.asarray(const_image),
        cam_refine=np.asarray(cam_refine, np.float64), **sh), dev), shard_pts


def problem_from_numpy(fields: dict, device) -> ShardedBAProblem:
    """ShardedBAProblem on `device` from host arrays named as its fields
    (floats in float64, the other dtypes kept)."""
    out = {}
    for k in ShardedBAProblem._fields:
        v = np.array(fields[k])
        out[k] = torch.as_tensor(
            v, dtype=DTYPE if v.dtype.kind == "f" else None, device=device)
    return ShardedBAProblem(**out)


def _local_problem(prob: ShardedBAProblem, shards: list) -> ba.BAProblem:
    """The union of `shards` as one port BAProblem: their points one
    after the other (shard shards[s]'s point p is point s Pd + p), their
    kept observations, the images and cameras as they are."""
    D, Pd = prob.points.shape[:2]
    host = (lambda a: a.cpu().numpy())
    om = host(prob.obs_mask)
    oi, op, oxy = host(prob.obs_image), host(prob.obs_point), \
        host(prob.obs_xy)
    rows = [np.nonzero(om[d])[0] for d in shards]
    cat = (lambda f: np.concatenate([f[d][r] for d, r in zip(shards, rows)])
           if shards else f[0][:0])
    point_off = np.concatenate([np.full(len(r), s * Pd, np.int64)
                                for s, r in enumerate(rows)] or
                               [np.zeros(0, np.int64)])
    return ba.problem_from_observations(
        host(prob.image_qvec), host(prob.image_tvec),
        host(prob.image_camidx), host(prob.cam_model_id),
        host(prob.cam_params),
        host(prob.points[shards]).reshape(-1, 3), cat(oi),
        cat(op).astype(np.int64) + point_off, cat(oxy),
        const_image=host(prob.const_image), cam_refine=host(prob.cam_refine),
        device=prob.points.device)


def _cost(local: ba.BAProblem, opts: ba.BAOptions) -> float:
    """Cauchy cost of scale loss_scale, summed over every rank."""
    with obs.span("ba.sharded.cost"):
        c = ba._plain_cost(local, opts._replace(loss="cauchy"))
        return obs.host_read(all_reduce(c.reshape(1))[0], float)


def _solve_dense(local: ba.BAProblem, pairs: ba.Pairs, r_w, Jc_w, Jp_w,
                 lam: float, opts: ba.BAOptions):
    """The reference's sharded dense step: S = U - W V⁻¹ Wᵀ over the
    rank's point pairs and gc, corr summed over the ranks in one reduce,
    then S's diagonal blocks damped by lam · max(diag, 1e-6), pinned
    images held, Cholesky. Returns (dcam, dpt)."""
    I = local.image_qvec.shape[0]
    dt, dev = r_w.dtype, r_w.device
    oi, op = local.obs_image, local.obs_point
    JcT = Jc_w.transpose(1, 2)
    gp, Vinv = ba._point_blocks(local, r_w, Jp_w, lam, opts)
    W = JcT @ Jp_w                                            # (N, 6, 3)
    Y = W @ Vinv[op]
    S = segment_sum(-(Y[pairs.a] @ W[pairs.b].transpose(1, 2)),
                    pairs.by_pp).reshape(I, I, 6, 6)
    diag = torch.arange(I, device=dev)
    S[diag, diag] += segment_sum(JcT @ Jc_w, local.by_image)
    S, gc, corr = all_reduce_many(
        S, segment_sum(mv(JcT, r_w), local.by_image),
        segment_sum(mv(Y, gp[op]), local.by_image))
    b = -gc - corr
    eye6 = torch.eye(6, dtype=dt, device=dev)
    S[diag, diag] += lam * eye6 * torch.clamp(
        S[diag, diag].diagonal(dim1=-2, dim2=-1), min=1e-6)[..., None]
    free = (~local.const_image).to(dt)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[diag, diag] += (1.0 - free)[:, None, None] * eye6
    dcam = ba._spd_solve(S.permute(0, 2, 1, 3).reshape(I * 6, I * 6),
                         (b * free[:, None]).reshape(-1)).reshape(I, 6)
    dcam = dcam * free[:, None]
    wtd = segment_sum(mtv(W, dcam[oi]), local.by_point)
    return dcam, mv(Vinv, gp - wtd)


def solve_sharded(prob: ShardedBAProblem,
                  opts: ba.BAOptions = ba.BAOptions()) -> tuple:
    """LM with the sharded Schur step on the process group (every rank
    calls it with the same problem). Returns (the problem with its
    poses, cameras and every shard's points updated on every rank,
    BAStats). One root span, `ba.sharded.solve`, counting its
    `lm_steps` and `cg_iterations` (and, in `parallel.mesh`, its
    collectives); inside it `ba.sharded.local` (the rank's local
    problem), `ba.sharded.cost` and each step's `ba.pcg`."""
    with obs.span("ba.sharded.solve"):
        out, stats = _solve_sharded(prob, opts)
        obs.count("lm_steps", stats.num_iterations)
        obs.count("cg_iterations", stats.cg_iterations)
    return out, stats


def _solve_sharded(prob: ShardedBAProblem, opts: ba.BAOptions) -> tuple:
    I = prob.image_qvec.shape[0]
    refine = ba._refine_any(opts)
    solver = ba._pick_solver(opts, I)
    if refine:
        solver = "iterative"     # the joint system is matrix-free only
    D, Pd = prob.points.shape[:2]
    shards = own_shards(D)
    with obs.span("ba.sharded.local"):
        local = _local_problem(prob, shards)
    pairs = ba._pairs(local, False) if solver == "dense" else None
    cost = init_cost = _cost(local, opts)
    lam, cg = float(opts.init_lambda), 0
    for _ in range(opts.max_iterations):
        r, Jc, Jp, Jg = ba._residuals_and_jacobians(local, refine)
        w = ba._robust_weights(torch.sum(r * r, -1), "cauchy",
                               opts.loss_scale)
        r_w, Jc_w, Jp_w, Jg_w = ba._weighted(local, r, Jc, Jp, Jg, w)
        dint = None
        if solver == "dense":
            dcam, dpt = _solve_dense(local, pairs, r_w, Jc_w, Jp_w, lam, opts)
        else:
            dcam, dint, dpt, k = ba._solve_iterative(
                local, r_w, Jc_w, Jp_w, Jg_w, lam, opts, None,
                all_reduce_many)
            cg += k
        trial = ba._apply_step(local, dcam, dpt, dint)
        new_cost = _cost(trial, opts)
        if new_cost < cost:
            local, cost = trial, new_cost
            lam = max(lam / 3.0, 1e-10)
        else:
            lam = min(lam * 4.0, 1e6)
    points = torch.zeros_like(prob.points)
    points[shards] = local.points.reshape(len(shards), Pd, 3)
    out = prob._replace(image_qvec=local.image_qvec,
                        image_tvec=local.image_tvec,
                        cam_params=local.cam_params,
                        points=all_reduce(points))
    return out, ba.BAStats(init_cost, cost, opts.max_iterations, lam, cg)


def gather_points(prob: ShardedBAProblem, shard_pts,
                  total_points: int) -> np.ndarray:
    """Every shard's points back in the original point order (numpy)."""
    out = np.zeros((total_points, 3))
    pts = prob.points.cpu().numpy()
    for d, idx in enumerate(shard_pts):
        out[idx] = pts[d, : len(idx)]
    return out
