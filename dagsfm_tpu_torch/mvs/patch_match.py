"""Multi-view stereo depth and normal estimation: a plane sweep, then
PatchMatch-style refinement, on the device.

Port of dagsfm_tpu/mvs/patch_match.py. The reference runs `lax.map` over
the depth hypotheses and `lax.scan` over the refinement iterations, one
source view at a time under `vmap`; here every source view is scored in
one batch of tensor ops, the plane sweep scores its hypotheses in chunks
of depths, and a refinement iteration scores its six proposals (four
neighbour shifts, two random perturbations) in one batch, since a
proposal's cost does not depend on the others. The cost volume kept is
(D, H, W): the mean of the top-k source costs per hypothesis.

Each function computes in its inputs' dtype (float32 on the card, as
the dense controller casts). The depth hypotheses are built in float64
with `jnp.linspace`'s own formula, so both packages sweep the same
planes. The random search draws its perturbations through one function,
`_draw_perturbations`, from a seeded `torch.Generator` on the CPU (so
the card and the CPU draw alike); torch cannot replay `jax.random`, and
the tests put the reference's draws there.

Cameras are pinhole (undistort first: scene/undistortion.py), COLMAP
convention: x_cam = R @ X_world + t, pixel = K @ x_cam.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# elements of a (depths, sources, H, W) batch scored at once
_CHUNK_ELEMENTS = 1 << 25


class PatchMatchOptions(NamedTuple):
    num_depths: int = 64           # plane-sweep hypotheses
    window_radius: int = 2         # ZNCC window = (2r+1)^2
    num_iterations: int = 5        # refinement sweeps
    perturbation: float = 0.1      # random-search relative depth range
    min_triangulation_angle: float = 1.0   # deg
    top_k: int = 2                 # average the k best source costs


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> tuple:
    """Sample img (H, W) at float coords y, x (any shape), or a stack
    (S, H, W) at coords (..., S, H', W'), source s from img[s]. Returns
    (values, in_bounds); out-of-bounds values are arbitrary."""
    H, W = img.shape[-2:]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    ok = (x >= 0) & (x <= W - 1.001) & (y >= 0) & (y <= H - 1.001)
    # clamp before the cast: a float far out of range has no integer
    xi = torch.clamp(torch.clamp(x0, -1, W).long(), 0, W - 2)
    yi = torch.clamp(torch.clamp(y0, -1, H).long(), 0, H - 2)
    idx = yi * W + xi
    if img.dim() == 3:
        idx = idx + torch.arange(img.shape[0], device=img.device)[
            :, None, None] * (H * W)
    flat = img.reshape(-1)
    v00 = flat[idx]
    v01 = flat[idx + 1]
    v10 = flat[idx + W]
    v11 = flat[idx + W + 1]
    v = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
         + v10 * fy * (1 - fx) + v11 * fy * fx)
    return v, ok


def _box(img: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W) mean over (2r+1)^2 windows, clipped at the borders (the
    window's in-bounds pixels only: the reference's reduce-window sum over
    its in-bounds count)."""
    w = 2 * r + 1
    shape = img.shape
    out = F.avg_pool2d(img.reshape(-1, 1, *shape[-2:]), w, stride=1,
                       padding=r, count_include_pad=False)
    return out.reshape(shape)


def _zncc_cost(ref: torch.Tensor, warped: torch.Tensor, valid: torch.Tensor,
               r: int) -> torch.Tensor:
    """1 - ZNCC over (2r+1)^2 windows of ref (H, W) against warped
    (..., H, W); invalid pixels get the maximum cost 2."""
    w = torch.where(valid, warped, 0.0)
    mu_r = _box(ref, r)
    var_r = _box(ref * ref, r) - mu_r * mu_r
    mu_w, box_ww, box_rw = _box(torch.stack([w, w * w, ref * w]), r)
    var_w = box_ww - mu_w * mu_w
    cov = box_rw - mu_r * mu_w
    ncc = cov * torch.rsqrt(torch.clamp(var_r * var_w, min=1e-10))
    cost = 1.0 - torch.clamp(ncc, -1.0, 1.0)
    return torch.where(valid, cost, 2.0)


def _pixel_rays(Kinv: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(3, H, W) K⁻¹ [x, y, 1] of every pixel."""
    dt, dev = Kinv.dtype, Kinv.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                            torch.arange(W, dtype=dt, device=dev),
                            indexing="ij")
    p = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    return (Kinv @ p).reshape(3, H, W)


def _warp_cost(ref_img, src_imgs, Kr_inv, Ks, R_rel, t_rel, depth,
               window_radius: int):
    """ZNCC cost of depth maps `depth` (..., H, W) against every source
    view of the stack src_imgs (S, H, W) (Ks, R_rel (S, 3, 3), t_rel
    (S, 3): src-from-ref): (..., S, H, W). A single source (H, W) with
    Ks, R_rel (3, 3) and t_rel (3,) gives (..., H, W).

    Each reference pixel is back-projected at its depth, moved into the
    source camera and projected: the homography of its fronto-parallel
    plane, evaluated per pixel. The 3 x 3 transforms are matrix products,
    as the reference's: on the CPU they round as its do, which decides
    the in-bounds test of a pixel that projects exactly onto an image
    edge."""
    if src_imgs.dim() == 2:
        return _warp_cost(ref_img, src_imgs[None], Kr_inv, Ks[None],
                          R_rel[None], t_rel[None], depth,
                          window_radius)[..., 0, :, :]
    H, W = ref_img.shape
    lead = depth.shape[:-2]
    X = (_pixel_rays(Kr_inv, H, W)[:, None] * depth.reshape(1, -1, H, W)
         ).reshape(3, -1)                              # (3, N)
    Xs = R_rel @ X + t_rel[:, :, None]                 # (S, 3, N)
    ps = torch.movedim(Ks @ Xs, 0, 1)                  # (3, S, N)
    ps = torch.movedim(ps.reshape((3, -1) + lead + (H, W)), 1, -3)
    z = ps[2]                                          # (..., S, H, W)
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    warped, ok = _bilinear(src_imgs, ps[1] / zs, ps[0] / zs)
    ok = ok & (z > 1e-6)
    return _zncc_cost(ref_img, warped, ok, window_radius)


def _multi_view_cost(ref_img, src_imgs, Kr_inv, Ks, R_rel, t_rel, depth,
                     opts: PatchMatchOptions):
    """Per-pixel cost of depth maps (..., H, W): the mean of the top_k
    smallest source costs. The leading dims are scored in chunks."""
    S = src_imgs.shape[0]
    k = min(opts.top_k, S)
    flat = depth.reshape((-1,) + depth.shape[-2:])
    per = max(1, _CHUNK_ELEMENTS // (S * depth.shape[-2] * depth.shape[-1]))
    out = []
    for c in range(0, flat.shape[0], per):
        costs = _warp_cost(ref_img, src_imgs, Kr_inv, Ks, R_rel, t_rel,
                           flat[c:c + per], opts.window_radius)
        top = torch.topk(costs, k, dim=-3, largest=False).values
        out.append(top.mean(dim=-3))
    return torch.cat(out).reshape(depth.shape)


def depth_hypotheses(depth_min: float, depth_max: float,
                     num: int) -> torch.Tensor:
    """(num,) float64 inverse depths from 1/depth_max to 1/depth_min by
    `jnp.linspace`'s formula: start (1 - i/div) + stop (i/div), the last
    one stop."""
    start, stop = 1.0 / depth_max, 1.0 / depth_min
    if num == 1:
        return torch.tensor([start], dtype=torch.float64)
    step = torch.arange(num - 1, dtype=torch.float64) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step,
                      torch.tensor([stop], dtype=torch.float64)])


def plane_sweep(ref_img: torch.Tensor, src_imgs: torch.Tensor,
                K_ref: torch.Tensor, K_src: torch.Tensor,
                R_rel: torch.Tensor, t_rel: torch.Tensor,
                depth_min: float, depth_max: float,
                opts: PatchMatchOptions = PatchMatchOptions()):
    """Initial depth by sweeping fronto-parallel planes, uniform in inverse
    depth (nearer planes denser). ref_img (H, W); src_imgs (S, H, W);
    K_src, R_rel (S, 3, 3), t_rel (S, 3): src-from-ref. Returns
    (depth (H, W), cost (H, W)); the depth is refined by a parabola through
    the best hypothesis' neighbours, in inverse depth."""
    dt, dev = ref_img.dtype, ref_img.device
    Kr_inv = torch.linalg.inv(K_ref)
    inv_d = depth_hypotheses(depth_min, depth_max, opts.num_depths)
    dmaps = (1.0 / inv_d).to(dtype=dt, device=dev)[:, None, None].expand(
        (-1,) + tuple(ref_img.shape))
    cost_vol = _multi_view_cost(ref_img, src_imgs, Kr_inv, K_src, R_rel,
                                t_rel, dmaps, opts)          # (D, H, W)
    best = torch.argmin(cost_vol, dim=0)                     # first of ties
    cmin = torch.amin(cost_vol, dim=0)

    D = opts.num_depths
    b0 = torch.clamp(best, 1, D - 2)
    c_m = torch.gather(cost_vol, 0, (b0 - 1)[None])[0]
    c_0 = torch.gather(cost_vol, 0, b0[None])[0]
    c_p = torch.gather(cost_vol, 0, (b0 + 1)[None])[0]
    denom = c_m - 2 * c_0 + c_p
    big = torch.abs(denom) > 1e-9
    off = torch.where(big, 0.5 * (c_m - c_p) / torch.where(big, denom, 1.0),
                      0.0)
    off = torch.clamp(off, -1.0, 1.0)
    idx = torch.clamp(b0 + off, 0, D - 1).to(torch.float64)
    inv_d = inv_d.to(dev)
    step = (inv_d[-1] - inv_d[0]) / (D - 1)
    inv = inv_d[0] + idx * step
    depth = (1.0 / torch.clamp(inv, min=1e-9)).to(dt)
    return depth, cmin


def _draw_perturbations(generator: torch.Generator, num_iterations: int,
                        shape: tuple, perturbation: float,
                        dtype: torch.dtype) -> torch.Tensor:
    """(num_iterations, 2, *shape) in `dtype` on the CPU: per iteration,
    the log-scale factors of the two random-search proposals, uniform in
    [-perturbation, perturbation) and a quarter of that."""
    u = torch.rand((num_iterations, 2) + tuple(shape), generator=generator,
                   dtype=dtype)
    scale = torch.tensor([perturbation, 0.25 * perturbation],
                         dtype=dtype).reshape((1, 2) + (1,) * len(shape))
    return u * (2 * scale) - scale


def refine(generator: torch.Generator, ref_img, src_imgs, K_ref, K_src,
           R_rel, t_rel, depth, depth_min: float, depth_max: float,
           opts: PatchMatchOptions = PatchMatchOptions()):
    """PatchMatch refinement: each iteration proposes the depth map
    shifted by one pixel in each of four directions (wrapping around, as
    the reference's `jnp.roll`) and two random multiplicative
    perturbations, scores the six at once, and takes each in turn where
    it lowers a pixel's cost. Returns (depth, cost)."""
    Kr_inv = torch.linalg.inv(K_ref)

    def cost_of(d):
        return _multi_view_cost(ref_img, src_imgs, Kr_inv, K_src, R_rel,
                                t_rel, d, opts)

    d = depth
    c = cost_of(d)
    draws = _draw_perturbations(generator, opts.num_iterations,
                                tuple(d.shape), opts.perturbation,
                                d.dtype).to(dtype=d.dtype, device=d.device)
    for it in range(opts.num_iterations):
        props = [torch.roll(d, 1, 0), torch.roll(d, -1, 0),
                 torch.roll(d, 1, 1), torch.roll(d, -1, 1)]
        props += [torch.clamp(d * torch.exp(draws[it, j]), depth_min,
                              depth_max) for j in range(2)]
        props = torch.stack(props)
        for p, pc in zip(props, cost_of(props)):
            take = pc < c
            d = torch.where(take, p, d)
            c = torch.where(take, pc, c)
    return d, c


def normals_from_depth(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Per-pixel normals (H, W, 3) from the gradients of the
    back-projected depth map, oriented toward the camera."""
    H, W = depth.shape
    P = _pixel_rays(torch.linalg.inv(K), H, W) * depth[None]
    dx = torch.gradient(P, dim=2)[0]
    dy = torch.gradient(P, dim=1)[0]
    n = torch.linalg.cross(torch.movedim(dx, 0, -1),
                           torch.movedim(dy, 0, -1))
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-9)
    view = torch.movedim(P, 0, -1)
    flip = torch.sum(n * view, -1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def estimate_depth_map(generator, ref_img, src_imgs, K_ref, K_src, R_rel,
                       t_rel, depth_min: float, depth_max: float,
                       opts: PatchMatchOptions = PatchMatchOptions()):
    """Sweep, refine, normals: (depth (H, W), normal (H, W, 3),
    cost (H, W))."""
    depth, _ = plane_sweep(ref_img, src_imgs, K_ref, K_src, R_rel, t_rel,
                           depth_min, depth_max, opts)
    depth, cost = refine(generator, ref_img, src_imgs, K_ref, K_src, R_rel,
                         t_rel, depth, depth_min, depth_max, opts)
    normal = normals_from_depth(depth, K_ref)
    return depth, normal, cost
