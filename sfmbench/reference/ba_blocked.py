"""Plain reference of the sharded final bundle adjustment's rule
(`parallel/ba_sharded.solve_sharded`), matrix-free and in blocks of
observations, for problems too large for a dense camera system.

The rule, written here from its description and not from the program:

* the observations kept: a track longer than T = max_track_len keeps
  the observations at the positions p (in the track's own order) where
  (p T) // size steps, T of them; a shorter track keeps all (`kept`);
* the cost: the Cauchy loss of scale c over the kept observations,
  c^2 log(1 + |r|^2 / c^2), a residual of 1e3 px per axis where the
  point lies within 1e-6 of the camera plane or behind it (`cost`);
* Levenberg-Marquardt (`lm`): exactly max_iterations steps; a step is
  kept when it lowers the cost; lambda / 3 (at least 1e-10) after a
  kept step, x 4 (at most 1e6) after a refused one;
* each step: residuals and Jacobians weighted by the square root of
  the Cauchy weight 1 / (1 + |r|^2 / c^2); unknowns per image a
  rotation increment on the left and a translation (held images: none),
  per camera the log focal length, k1 and k2 where free; the points
  eliminated by the Schur complement, each 3 x 3 block damped by
  lambda max(diag, 1e-6) + point_damping and 1e-12; the pose and
  intrinsics blocks damped by lambda max(diag, 1e-6); the reduced
  camera system solved by conjugate gradients from zero with a block
  Jacobi preconditioner (each image's pose block and each camera's
  intrinsics block of the reduced system, symmetrised, 1e-10 added,
  inverted; their coupling left out), stopping when |r| <= rtol |b| or
  after max_linear_iterations; the points then by back-substitution.

Camera models: the single-focal radial family (RADIAL: f, cx, cy, k1,
k2; SIMPLE_RADIAL and SIMPLE_PINHOLE as RADIAL with k2, or k1 and k2,
zero and held). The principal point is held.

Every sum over observations runs block by block (`block` observations),
so that the largest temporary is a block's; the problem keeps per
observation only its indices, pixels and the two 3-column blocks of
the point-camera coupling. `dtype` sets the precision: float64 for the
judge, float32 for the control. Imports no module of the program.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

BLOCK = 1 << 20


def kept(obs_point: torch.Tensor, num_points: int,
         max_track_len: int) -> torch.Tensor:
    """(N,) bool: the observations the rule keeps (every observation
    counts as live; their order within a track is their order in
    obs_point)."""
    N, T = obs_point.shape[0], max_track_len
    order = torch.argsort(obs_point, stable=True)
    p = obs_point[order]
    size = torch.bincount(p, minlength=num_points)
    first = torch.cumsum(size, 0) - size
    pos = torch.arange(N, device=p.device) - first[p]
    sz = size[p]
    keep = (sz <= T) | ((pos * T) // sz != ((pos + 1) * T) // sz)
    out = torch.zeros(N, dtype=torch.bool, device=p.device)
    out[order] = keep
    return out


def prepare(obs_image, obs_point, obs_xy, image_cam, num_points: int,
            max_track_len: int, dtype=torch.float64,
            block: int = BLOCK) -> dict:
    """The kept observations (in their order), with each one's camera,
    pixels in `dtype`, and the counts."""
    keep = kept(obs_point, num_points, max_track_len)
    idx = torch.nonzero(keep)[:, 0]
    image = obs_image[idx].long()
    return dict(image=image, point=obs_point[idx].long(),
                cam=image_cam.long()[image], xy=obs_xy[idx].to(dtype),
                kept=keep, I=image_cam.shape[0],
                C=int(image_cam.max()) + 1, P=num_points, block=block)


def _blocks(obs: dict):
    n, b = obs["image"].shape[0], obs["block"]
    return [slice(s, min(s + b, n)) for s in range(0, n, b)]


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def rotation_exp(w: torch.Tensor) -> torch.Tensor:
    """exp([w]x) by Rodrigues' formula (series below 1e-8 rad)."""
    a = torch.linalg.norm(w, dim=-1)[..., None, None]
    K = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    small = a < 1e-8
    safe = torch.where(small, torch.ones_like(a), a)
    s = torch.where(small, 1 - a * a / 6, torch.sin(safe) / safe)
    c = torch.where(small, 0.5 - a * a / 24, (1 - torch.cos(safe)) /
                    (safe * safe))
    return torch.eye(3, dtype=w.dtype, device=w.device) + s * K + c * (K @ K)


def solution(qvec, tvec, intr, points, image_cam,
             dtype=torch.float64) -> dict:
    """A solution in the reference's form: world-to-camera rotations
    from quaternions (w, x, y, z), translations, per camera (f, cx, cy,
    k1, k2), points; `image_cam` is each image's camera."""
    cast = (lambda a: a.to(dtype))
    return dict(R=quat_to_rotmat(cast(qvec)), tvec=cast(tvec),
                intr=cast(intr[:, :5]), points=cast(points),
                image_cam=image_cam.long())


def _pixels(R, t, k, X):
    """RADIAL pixels of points X (..., 3) and the camera depths."""
    Xc = (R @ X[..., None])[..., 0] + t
    z = Xc[..., 2:3]
    u = Xc[..., :2] / torch.where(z.abs() < 1e-12, 1e-12, z)
    r2 = torch.sum(u * u, -1, keepdim=True)
    pix = k[..., 0:1] * u * (1 + r2 * (k[..., 3:4] + k[..., 4:5] * r2)) \
        + k[..., 1:3]
    return pix, z[..., 0]


def residuals(sol: dict, obs: dict, s: slice) -> torch.Tensor:
    """(B, 2) residuals of the block s; 1e3 where the depth is at most
    1e-6."""
    oi, op, oc = obs["image"][s], obs["point"][s], obs["cam"][s]
    pix, z = _pixels(sol["R"][oi], sol["tvec"][oi], sol["intr"][oc],
                     sol["points"][op])
    r = pix - obs["xy"][s]
    return torch.where((z > 1e-6)[:, None], r, torch.full_like(r, 1e3))


def cost(sol: dict, obs: dict, loss_scale: float = 1.0) -> torch.Tensor:
    c2 = loss_scale * loss_scale
    total = sol["tvec"].new_zeros(())
    for s in _blocks(obs):
        r = residuals(sol, obs, s)
        total = total + torch.sum(c2 * torch.log1p(torch.sum(r * r, -1) /
                                                    c2))
    return total


def _one(p, R, X, t, k, xy):
    """Residual (2,) of one observation at an increment p (12,): the
    rotation on the left (3, to first order), translation (3), log
    focal, k1, k2 (3), point (3)."""
    RX = R @ (X + p[9:12])
    Xc = RX + torch.linalg.cross(p[0:3], R @ X) + t + p[3:6]
    u = Xc[:2] / Xc[2]
    r2 = torch.sum(u * u)
    radial = 1 + r2 * (k[3] + p[7] + (k[4] + p[8]) * r2)
    return k[0] * torch.exp(p[6]) * u * radial + k[1:3] - xy


_jacobian = vmap(jacfwd(_one), in_dims=(None, 0, 0, 0, 0, 0))


def _outer(a, b):
    """Per row, a^T b of (B, 2, m) and (B, 2, n): (B, m, n)."""
    return (a[..., :, None] * b[..., None, :]).sum(1)


def _mv(A, x):
    """Per row, A x of (B, m, n) and (B, n): (B, m)."""
    return (A * x[..., None, :]).sum(-1)


def _mtv(A, x):
    """Per row, A^T x of (B, m, n) and (B, m): (B, n)."""
    return (A * x[..., :, None]).sum(-2)


def _linearize(sol, obs, s, free_p, free_g, loss_scale):
    """Weighted residuals (B, 2) and Jacobians of the block s: pose (B,
    2, 6; zero on held images), intrinsics (B, 2, 3; zero where held),
    point (B, 2, 3)."""
    oi, op, oc = obs["image"][s], obs["point"][s], obs["cam"][s]
    R, X = sol["R"][oi], sol["points"][op]
    r = residuals(sol, obs, s)
    J = _jacobian(torch.zeros(12, dtype=r.dtype, device=r.device), R, X,
                  sol["tvec"][oi], sol["intr"][oc], obs["xy"][s])
    z = ((R @ X[..., None])[..., 0] + sol["tvec"][oi])[:, 2]
    J = torch.where((z > 1e-6)[:, None, None], J, torch.zeros_like(J))
    w = 1.0 / (1.0 + torch.sum(r * r, -1) / (loss_scale * loss_scale))
    sw = torch.sqrt(w)[:, None]
    J = J * sw[..., None]
    return (r * sw, J[..., :6] * free_p[oi][:, None, :],
            J[..., 6:9] * free_g[oc][:, None, :], J[..., 9:12])


def _damp(U, lam):
    d = torch.clamp(U.diagonal(dim1=-2, dim2=-1), min=1e-6)
    return U + lam * torch.diag_embed(d)


def _block_inverse(M, free):
    """Inverse of each block, held rows and columns those of the
    identity; symmetrised, 1e-10 on the diagonal."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    M = M * (free[..., :, None] * free[..., None, :]) + \
        torch.diag_embed(1.0 - free)
    return torch.linalg.inv(0.5 * (M + M.transpose(-1, -2)) + 1e-10 * eye)


def _step(sol, obs, free_p, free_g, lam, o):
    """One damped step of the rule from `sol`: (trial solution, CG
    iterations)."""
    I, C, P = obs["I"], obs["C"], obs["P"]
    dt, dev = sol["tvec"].dtype, sol["tvec"].device
    z = (lambda *shape: torch.zeros(shape, dtype=dt, device=dev))
    Upp, Upg, Ugg = z(I, 6, 6), z(I, 6, 3), z(C, 3, 3)
    g_p, g_g, V, gp = z(I, 6), z(C, 3), z(P, 3, 3), z(P, 3)
    blocks, W = _blocks(obs), []
    for s in blocks:
        oi, op, oc = obs["image"][s], obs["point"][s], obs["cam"][s]
        r, Jc, Jg, Jp = _linearize(sol, obs, s, free_p, free_g,
                                   o["loss_scale"])
        Upp.index_add_(0, oi, _outer(Jc, Jc))
        Upg.index_add_(0, oi, _outer(Jc, Jg))
        Ugg.index_add_(0, oc, _outer(Jg, Jg))
        g_p.index_add_(0, oi, _outer(Jc, r[..., None])[..., 0])
        g_g.index_add_(0, oc, _outer(Jg, r[..., None])[..., 0])
        V.index_add_(0, op, _outer(Jp, Jp))
        gp.index_add_(0, op, -_outer(Jp, r[..., None])[..., 0])
        W.append((_outer(Jc, Jp), _outer(Jg, Jp)))
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Vinv = torch.linalg.inv(
        V + torch.diag_embed(lam * torch.clamp(
            V.diagonal(dim1=-2, dim2=-1), min=1e-6) + o["point_damping"])
        + 1e-12 * eye3)
    corr_p, corr_g, B_p, B_g = z(I, 6), z(C, 3), z(I, 6, 6), z(C, 3, 3)
    for s, (Wc, Wg) in zip(blocks, W):
        oi, op, oc = obs["image"][s], obs["point"][s], obs["cam"][s]
        Vo = Vinv[op]
        Yc = (Wc[..., :, :, None] * Vo[..., None, :, :]).sum(-2)
        Yg = (Wg[..., :, :, None] * Vo[..., None, :, :]).sum(-2)
        corr_p.index_add_(0, oi, _mv(Yc, gp[op]))
        corr_g.index_add_(0, oc, _mv(Yg, gp[op]))
        B_p.index_add_(0, oi, (Yc[..., :, None, :] *
                               Wc[..., None, :, :]).sum(-1))
        B_g.index_add_(0, oc, (Yg[..., :, None, :] *
                               Wg[..., None, :, :]).sum(-1))
    Upp_d, Ugg_d = _damp(Upp, lam), _damp(Ugg, lam)
    b = ((-g_p - corr_p) * free_p, (-g_g - corr_g) * free_g)
    Mp = _block_inverse(Upp_d - B_p, free_p)
    Mg = _block_inverse(Ugg_d - B_g, free_g)
    cam_of = sol["image_cam"]

    def points_side(xp, xg):
        t = z(P, 3)
        for s, (Wc, Wg) in zip(blocks, W):
            t.index_add_(0, obs["point"][s],
                         _mtv(Wc, xp[obs["image"][s]]) +
                         _mtv(Wg, xg[obs["cam"][s]]))
        return t

    def S_mv(xp, xg):
        xp, xg_ = xp * free_p, xg * free_g
        y = (Vinv @ points_side(xp, xg_)[..., None])[..., 0]
        zc, zg = z(I, 6), z(C, 3)
        for s, (Wc, Wg) in zip(blocks, W):
            yo = y[obs["point"][s]]
            zc.index_add_(0, obs["image"][s], _mv(Wc, yo))
            zg.index_add_(0, obs["cam"][s], _mv(Wg, yo))
        Sp = _mv(Upp_d, xp) + _mv(Upg, xg_[cam_of]) - zc
        Sg = _mv(Ugg_d, xg_) + z(C, 3).index_add_(0, cam_of,
                                                   _mtv(Upg, xp)) - zg
        return Sp * free_p, Sg * free_g

    def dot(a, c):
        return sum(torch.sum(u * w) for u, w in zip(a, c))

    def precond(rp, rg):
        return _mv(Mp, rp), _mv(Mg, rg)

    # CG from zero on the free unknowns (the held ones stay zero)
    tol = o["linear_rtol"] * torch.clamp(torch.sqrt(dot(b, b)), min=1e-30)
    x, r = (z(I, 6), z(C, 3)), b
    zr = precond(*r)
    p, rz, k = zr, dot(r, zr), 0
    while k < o["max_linear_iterations"] and \
            bool(torch.sqrt(dot(r, r)) > tol):
        Ap = S_mv(*p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-30, 1e-30, pAp)
        x = tuple(u + alpha * w for u, w in zip(x, p))
        r = tuple(u - alpha * w for u, w in zip(r, Ap))
        zr = precond(*r)
        rz_new = dot(r, zr)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-30, 1e-30, rz)
        p = tuple(u + beta * w for u, w in zip(zr, p))
        rz = rz_new
        k += 1
    dp, dg = x[0] * free_p, x[1] * free_g
    dX = (Vinv @ (gp - points_side(dp, dg))[..., None])[..., 0]
    intr = sol["intr"].clone()
    intr[:, 0] = intr[:, 0] * torch.exp(dg[:, 0])
    intr[:, 3] = intr[:, 3] + dg[:, 1]
    intr[:, 4] = intr[:, 4] + dg[:, 2]
    return dict(R=rotation_exp(dp[:, :3]) @ sol["R"],
                tvec=sol["tvec"] + dp[:, 3:], intr=intr,
                points=sol["points"] + dX, image_cam=cam_of), k


def lm(sol: dict, obs: dict, held, free_intr, max_iterations: int,
       loss_scale: float = 1.0, linear_rtol: float = 0.03,
       max_linear_iterations: int = 100, init_lambda: float = 1e-4,
       point_damping: float = 1e-8) -> tuple:
    """The rule's Levenberg-Marquardt from `sol` (every tensor in one
    dtype; obs from `prepare` in it). held (I,) bool: the images whose
    poses are held; free_intr (C, 3): which of log f, k1, k2 move.
    Returns (solution, initial cost, final cost, CG iterations)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dt = sol["tvec"].dtype
        free_p = (~held.bool()).to(dt)[:, None].expand(-1, 6)
        free_g = free_intr.to(dt)
        o = dict(loss_scale=loss_scale, linear_rtol=linear_rtol,
                 max_linear_iterations=max_linear_iterations,
                 point_damping=point_damping)
        c = c0 = float(cost(sol, obs, loss_scale))
        lam, cg = float(init_lambda), 0
        for _ in range(max_iterations):
            trial, k = _step(sol, obs, free_p, free_g, lam, o)
            cg += k
            new = float(cost(trial, obs, loss_scale))
            if new < c:
                sol, c = trial, new
                lam = max(lam / 3.0, 1e-10)
            else:
                lam = min(lam * 4.0, 1e6)
        return sol, c0, c, cg
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
