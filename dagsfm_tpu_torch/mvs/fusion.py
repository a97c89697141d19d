"""Depth-map fusion with geometric consistency into a dense point cloud.

Port of dagsfm_tpu/mvs/fusion.py. Every pixel of a reference view is
back-projected, projected into a source view, compared with the source's
depth there and projected back (relative depth error, round-trip
reprojection error), all pixels at once on the device; a view's counts of
consistent sources stay on the device until its pixels are gathered, on
the host with numpy as the reference does. `voxel_size > 0` keeps the
first point of each voxel, as the reference's `np.unique(axis=0)`, through
one integer key per voxel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.mvs.patch_match import _bilinear, _pixel_rays


class FusionOptions(NamedTuple):
    max_reproj_error: float = 2.0     # px
    max_depth_error: float = 0.01     # relative
    max_normal_error_deg: float = 10.0
    min_num_consistent: int = 2
    voxel_size: float = 0.0           # > 0: dedupe fused points on a grid


def _consistency_terms(depth_ref, K_ref, R_ref, t_ref, depth_src, K_src,
                       R_src, t_src) -> tuple:
    """(in bounds and in front, projected depth z, sampled source depth,
    round-trip reprojection error), each (H, W): every reference pixel
    back-projected to the world, projected into the source view, the
    source depth sampled there, back-projected and projected into the
    reference view again."""
    H, W = depth_ref.shape
    Xc = _pixel_rays(torch.linalg.inv(K_ref), H, W) * depth_ref[None]
    Xw = torch.einsum("ji,jhw->ihw", R_ref, Xc - t_ref[:, None, None])
    Xs = torch.einsum("ij,jhw->ihw", R_src, Xw) + t_src[:, None, None]
    z = Xs[2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    px = K_src[0, 0] * (Xs[0] / zs) + K_src[0, 2]
    py = K_src[1, 1] * (Xs[1] / zs) + K_src[1, 2]
    d_src, ok = _bilinear(depth_src, py, px)

    rays_s = torch.einsum("ij,jhw->ihw", torch.linalg.inv(K_src),
                          torch.stack([px, py, torch.ones_like(px)]))
    Xw2 = torch.einsum("ji,jhw->ihw", R_src,
                       rays_s * d_src[None] - t_src[:, None, None])
    Xr2 = torch.einsum("ij,jhw->ihw", R_ref, Xw2) + t_ref[:, None, None]
    z2 = torch.where(torch.abs(Xr2[2]) < 1e-9,
                     torch.full_like(Xr2[2], 1e-9), Xr2[2])
    px2 = K_ref[0, 0] * Xr2[0] / z2 + K_ref[0, 2]
    py2 = K_ref[1, 1] * Xr2[1] / z2 + K_ref[1, 2]
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=z.dtype, device=z.device),
        torch.arange(W, dtype=z.dtype, device=z.device), indexing="ij")
    reproj = torch.sqrt((px2 - xs) ** 2 + (py2 - ys) ** 2)
    return ok & (z > 0), z, d_src, reproj


def consistency_check(depth_ref, normal_ref, K_ref, R_ref, t_ref,
                      depth_src, K_src, R_src, t_src,
                      max_reproj_error: float, max_depth_error: float):
    """(H, W) bool: the reference view's pixels consistent with ONE source
    view (tensors on one device, in the depth maps' dtype;
    `normal_ref` is not read, as in the reference)."""
    ok, z, d_src, reproj = _consistency_terms(
        depth_ref, K_ref, R_ref, t_ref, depth_src, K_src, R_src, t_src)
    depth_ok = torch.abs(d_src - z) < max_depth_error * torch.abs(z)
    return ok & depth_ok & (reproj < max_reproj_error)


def voxel_first(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """Indices of the first point in each voxel of the grid, in the
    lexicographic order of the voxels: `np.unique(floor(xyz / voxel_size),
    axis=0, return_index=True)[1]`, with the three voxel coordinates
    packed into one int64 key where their ranges allow."""
    key = np.floor(xyz / voxel_size).astype(np.int64)
    lo = key.min(0)
    span = key.max(0) - lo + 1
    if float(np.prod(span.astype(np.float64))) >= 2.0 ** 62:
        return np.unique(key, axis=0, return_index=True)[1]
    k = key - lo
    packed = (k[:, 0] * span[1] + k[:, 1]) * span[2] + k[:, 2]
    return np.unique(packed, return_index=True)[1]


def fuse(depths: list, normals: list, images: list, Ks: list, Rs: list,
         ts: list, opts: FusionOptions = FusionOptions(),
         device=None) -> dict:
    """Fuse per-view depth maps into one point cloud.

    depths / normals / images: per view (H, W) / (H, W, 3) / (H, W)
    arrays or tensors (normals and images may be None). The checks run
    on `device` in the depth maps' dtype. Returns a dict with "xyz"
    (N, 3), "normal", "color", "num_consistent" (host numpy)."""
    dev = devmod.resolve(device)
    n_views = len(depths)
    D = [torch.as_tensor(d, device=dev) for d in depths]
    dt = D[0].dtype
    cams = [tuple(torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
                  for a in (Ks[v], Rs[v], ts[v])) for v in range(n_views)]
    out_xyz, out_nrm, out_col, out_cnt = [], [], [], []
    for r in range(n_views):
        count = torch.zeros(D[r].shape, dtype=torch.int32, device=dev)
        for s in range(n_views):
            if s != r:
                count += consistency_check(
                    D[r], None, *cams[r], D[s], *cams[s],
                    opts.max_reproj_error, opts.max_depth_error)
        keep = ((count >= opts.min_num_consistent) & (D[r] > 0)).cpu().numpy()
        if not keep.any():
            continue
        ys, xs = np.nonzero(keep)
        d = D[r].cpu().numpy()[ys, xs]
        Kinv = np.linalg.inv(np.asarray(Ks[r]))
        pix = np.stack([xs, ys, np.ones_like(xs)]).astype(np.float64)
        Xc = (Kinv @ pix) * d
        Xw = np.asarray(Rs[r]).T @ (Xc - np.asarray(ts[r])[:, None])
        out_xyz.append(Xw.T)
        out_cnt.append(count.cpu().numpy()[ys, xs])
        if normals[r] is not None:
            nc = _host(normals[r])[ys, xs]            # cam-frame normals
            out_nrm.append(nc @ np.asarray(Rs[r]))    # -> world (Rᵀ n)
        if images[r] is not None:
            out_col.append(_host(images[r])[ys, xs])

    if not out_xyz:
        return {"xyz": np.zeros((0, 3)), "normal": np.zeros((0, 3)),
                "color": np.zeros((0,)), "num_consistent": np.zeros(0, int)}
    xyz = np.concatenate(out_xyz)
    nrm = np.concatenate(out_nrm) if out_nrm else np.zeros_like(xyz)
    col = np.concatenate(out_col) if out_col else np.zeros(len(xyz))
    cnt = np.concatenate(out_cnt)

    if opts.voxel_size > 0:
        idx = voxel_first(xyz, opts.voxel_size)
        xyz, nrm, col, cnt = xyz[idx], nrm[idx], col[idx], cnt[idx]
    return {"xyz": xyz, "normal": nrm, "color": col, "num_consistent": cnt}


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
