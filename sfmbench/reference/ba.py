"""Plain reference of bundle adjustment on RADIAL cameras (f, cx, cy, k1,
k2; one camera per image), with a Cauchy loss.

`cost` is the robust cost of a solution against the observations;
`lm` runs Levenberg-Marquardt from a solution: residuals and their
Jacobians by forward-mode differentiation of one observation's
projection, the normal equations reduced to the cameras by the Schur
complement, formed dense (nine unknowns per image: a rotation increment
on the left, a translation, the log focal length, k1 and k2) and solved
by Cholesky. The first `held` images keep their poses; every camera's
focal length, k1 and k2 move. The principal point is held.

It takes the observations as the benchmark made them and a solution as
quaternions (w, x, y, z), translations, (I, 5) intrinsics and points; it
works out everything else itself. `dtype` sets the precision: float64
for the judge, float32 for the control.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z,
    ], -1).reshape(q.shape[:-1] + (3, 3))


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    a = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    small = a < 1e-8
    s = torch.where(small, 1.0 - a * a / 6, torch.sin(a) / torch.where(
        small, 1.0, a))
    c = torch.where(small, 0.5 - a * a / 24, (1 - torch.cos(a)) / torch.where(
        small, 1.0, a * a))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + s * K + c * (K @ K)


def residuals(sol: dict, obs: dict) -> torch.Tensor:
    """(N, 2) pixels less observations; 1e3 where the point is behind."""
    oi, op = obs["image"], obs["point"]
    R = sol["R"][oi]
    Xc = (R @ sol["points"][op][..., None])[..., 0] + sol["tvec"][oi]
    z = Xc[:, 2:3]
    k = sol["intr"][oi]
    u = Xc[:, :2] / torch.where(z.abs() < 1e-12, 1e-12, z)
    r2 = torch.sum(u * u, -1, keepdim=True)
    pix = k[:, 0:1] * u * (1 + r2 * (k[:, 3:4] + k[:, 4:5] * r2)) + k[:, 1:3]
    r = pix - obs["xy"]
    return torch.where(z > 1e-6, r, torch.full_like(r, 1e3))


def cost(sol: dict, obs: dict, loss_scale: float = 1.0) -> torch.Tensor:
    r = residuals(sol, obs)
    c2 = loss_scale * loss_scale
    return torch.sum(c2 * torch.log1p(torch.sum(r * r, -1) / c2))


def _one(p, R, X, t, k, xy):
    """Residual (2,) of one observation at an increment p (12,): rotation
    (3), translation (3), log focal, k1, k2 (3), point (3)."""
    RX = R @ (X + p[9:12])
    Xc = RX + torch.linalg.cross(p[0:3], R @ X) + t + p[3:6]
    u = Xc[:2] / Xc[2]
    r2 = torch.sum(u * u)
    radial = 1 + r2 * (k[3] + p[7] + (k[4] + p[8]) * r2)
    return k[0] * torch.exp(p[6]) * u * radial + k[1:3] - xy


_jac = vmap(jacfwd(_one), in_dims=(None, 0, 0, 0, 0, 0))


def from_program(qvec, tvec, intr, points, dtype=torch.float64) -> dict:
    """A solution in the reference's form, in `dtype`."""
    cast = (lambda a: a.to(dtype))
    return dict(R=quat_to_rotmat(cast(qvec)), tvec=cast(tvec),
                intr=cast(intr), points=cast(points))


def prepare(obs_image, obs_point, obs_xy, num_images: int, num_points: int,
            dtype=torch.float64, chunk_elems: int = 1 << 27) -> dict:
    """Observations sorted by point, with the point chunks of the dense
    Schur assembly (at most chunk_elems entries of a chunk's matrices)."""
    order = torch.argsort(obs_point, stable=True)
    op = obs_point[order]
    pc = max(1, chunk_elems // (27 * num_images))
    bounds = list(range(0, num_points, pc)) + [num_points]
    starts = torch.searchsorted(op, torch.tensor(bounds, device=op.device))
    return dict(image=obs_image[order], point=op, xy=obs_xy[order].to(dtype),
                I=num_images, P=num_points, bounds=bounds,
                starts=starts.tolist())


def _step(sol, obs, held, lam, loss_scale):
    oi, op = obs["image"], obs["point"]
    I, P = obs["I"], obs["P"]
    dt = sol["tvec"].dtype
    N = len(oi)
    J = _jac(torch.zeros(12, dtype=dt, device=oi.device), sol["R"][oi],
             sol["points"][op], sol["tvec"][oi], sol["intr"][oi], obs["xy"])
    r = residuals(sol, obs)
    w = 1.0 / (1.0 + torch.sum(r * r, -1) / (loss_scale * loss_scale))
    sw = torch.sqrt(w)[:, None]
    r = r * sw
    J = J * sw[..., None]
    pinned = (oi < held)[:, None, None]
    Jc = torch.cat([torch.where(pinned, 0.0, J[..., :6]), J[..., 6:9]], -1)
    Jp = J[..., 9:]
    JcT = Jc.transpose(1, 2)
    JpT = Jp.transpose(1, 2)
    U = torch.zeros((I, 9, 9), dtype=dt, device=oi.device).index_add_(
        0, oi, JcT @ Jc)
    gc = torch.zeros((I, 9), dtype=dt, device=oi.device).index_add_(
        0, oi, (JcT @ r[..., None])[..., 0])
    V = torch.zeros((P, 3, 3), dtype=dt, device=oi.device).index_add_(
        0, op, JpT @ Jp)
    gp = torch.zeros((P, 3), dtype=dt, device=oi.device).index_add_(
        0, op, (JpT @ r[..., None])[..., 0])
    Wn = JcT @ Jp                                             # (N, 9, 3)
    eye3 = torch.eye(3, dtype=dt, device=oi.device)
    Vd = V + lam * torch.diag_embed(torch.clamp(
        V.diagonal(dim1=-2, dim2=-1), min=1e-6)) + 1e-12 * eye3
    Vinv = torch.linalg.inv(Vd)
    Ud = U + lam * torch.diag_embed(torch.clamp(
        U.diagonal(dim1=-2, dim2=-1), min=1e-6))
    Yn = Wn @ Vinv[op]                                        # (N, 9, 3)
    b = -gc + torch.zeros((I, 9), dtype=dt, device=oi.device).index_add_(
        0, oi, (Yn @ gp[op][..., None])[..., 0])
    n9 = 9 * I
    S = torch.zeros((n9, n9), dtype=dt, device=oi.device)
    blk = (9 * torch.arange(I, device=oi.device))[:, None] + torch.arange(
        9, device=oi.device)
    S[blk[:, :, None], blk[:, None, :]] = Ud
    a9 = torch.arange(9, device=oi.device)
    a3 = torch.arange(3, device=oi.device)
    for c in range(len(obs["bounds"]) - 1):
        s, e = obs["starts"][c], obs["starts"][c + 1]
        if s == e:
            continue
        p0 = obs["bounds"][c]
        width = 3 * (obs["bounds"][c + 1] - p0)
        rows = (9 * oi[s:e])[:, None, None] + a9[None, :, None]
        cols = (3 * (op[s:e] - p0))[:, None, None] + a3[None, None, :]
        Y = torch.zeros((n9, width), dtype=dt, device=oi.device)
        Wd = torch.zeros((n9, width), dtype=dt, device=oi.device)
        Y[rows, cols] = Yn[s:e]
        Wd[rows, cols] = Wn[s:e]
        S -= Y @ Wd.T
        del Y, Wd
    held_rows = (9 * torch.arange(held, device=oi.device))[:, None] \
        + torch.arange(6, device=oi.device)
    held_rows = held_rows.reshape(-1)
    S[held_rows, held_rows] += 1.0
    S = 0.5 * (S + S.T)
    L, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        return None
    dc = torch.cholesky_solve(b.reshape(-1, 1), L).reshape(I, 9)
    dc[:held, :6] = 0.0
    wtd = torch.zeros((P, 3), dtype=dt, device=oi.device).index_add_(
        0, op, (Wn.transpose(1, 2) @ dc[oi][..., None])[..., 0])
    dp = (Vinv @ (-gp - wtd)[..., None])[..., 0]
    intr = sol["intr"].clone()
    intr[:, 0] = intr[:, 0] * torch.exp(dc[:, 6])
    intr[:, 3] = intr[:, 3] + dc[:, 7]
    intr[:, 4] = intr[:, 4] + dc[:, 8]
    return dict(R=rodrigues(dc[:, :3]) @ sol["R"], tvec=sol["tvec"] + dc[:, 3:6],
                intr=intr, points=sol["points"] + dp)


def lm(sol: dict, obs: dict, held: int, max_iterations: int,
       ftol: float = 0.0, loss_scale: float = 1.0, lam: float = 1e-4):
    """Levenberg-Marquardt from `sol` (every tensor in one dtype; obs
    from `prepare` in the same dtype). Each trial step counts as an
    iteration; a step is kept when it lowers the cost. With ftol > 0 it
    stops after two kept steps in a row that each gain less than ftol of
    the cost, or a refused step at the damping's ceiling. Returns
    (solution, its cost, iterations)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c = float(cost(sol, obs, loss_scale))
        small, it = 0, 0
        while it < max_iterations:
            it += 1
            trial = _step(sol, obs, held, lam, loss_scale)
            new = float(cost(trial, obs, loss_scale)) if trial is not None \
                else float("inf")
            if new < c:
                rel = (c - new) / max(c, 1e-30)
                sol, c = trial, new
                lam = max(lam / 3.0, 1e-10)
                small = small + 1 if rel < ftol else 0
                if ftol > 0 and small >= 2:
                    break
            else:
                small = 0
                if ftol > 0 and lam >= 1e6:
                    break
                lam = min(lam * 4.0, 1e6)
        return sol, c, it
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
