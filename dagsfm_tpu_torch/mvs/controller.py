"""PatchMatch controller: dense reconstruction of a sparse model.

Port of dagsfm_tpu/mvs/controller.py: for each registered image pick
source views by shared sparse points (COLMAP's "__auto__" source
selection), take the depth range from the sparse points it sees, run the
plane sweep and PatchMatch refinement (patch_match.py), write
COLMAP-format depth and normal maps, then fuse them (fusion.py).

The dense path runs in float32 on the device (`DENSE_DTYPE`), as the
reference casts its images and cameras. The reference's per-view key
chain (`jax.random.split` once per view) becomes one `torch.Generator`
seeded with `seed`, from which each view's refinement draws in turn.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.mvs import fusion
from dagsfm_tpu_torch.mvs import io as mvs_io
from dagsfm_tpu_torch.mvs import patch_match as pm
from dagsfm_tpu_torch.ops import rotations as rops

DENSE_DTYPE = torch.float32


class DenseOptions(NamedTuple):
    max_src_images: int = 4       # COLMAP's max_num_src_images
    depth_margin: float = 0.25    # widen the sparse range by this fraction
    patch_match: pm.PatchMatchOptions = pm.PatchMatchOptions()
    fusion: fusion.FusionOptions = fusion.FusionOptions()


def _K_R_t(rec, image_id):
    im = rec.images[image_id]
    cam = rec.cameras[im.camera_id]
    K = np.asarray(cam.calibration_matrix(), np.float64)
    R = rops.quat_to_rotmat_np(im.qvec)
    return K, R, np.asarray(im.tvec, np.float64)


def select_source_images(rec, ref_id: int, max_src: int) -> list:
    """Source views ranked by the sparse points they share with the
    reference view (count, then image id, both descending)."""
    ref_pts = np.unique(rec.images[ref_id].point3D_ids)
    ref_pts = ref_pts[ref_pts >= 0]
    scores = []
    for iid in rec.reg_image_ids:
        if iid == ref_id:
            continue
        shared = int(np.isin(rec.images[iid].point3D_ids, ref_pts).sum())
        if shared > 0:
            scores.append((shared, iid))
    scores.sort(reverse=True)
    return [iid for _, iid in scores[:max_src]]


def depth_range(rec, image_id: int, margin: float) -> tuple:
    """Depth range from the view's sparse points: the 1st to 99th
    percentile, widened by `margin` of its span on each side."""
    K, R, t = _K_R_t(rec, image_id)
    im = rec.images[image_id]
    pts = [rec.points3D[int(p)].xyz for p in im.point3D_ids if p >= 0]
    if not pts:
        return 0.1, 100.0
    z = (np.asarray(pts) @ R.T + t)[:, 2]
    z = z[z > 1e-6]
    if len(z) == 0:
        return 0.1, 100.0
    lo, hi = np.percentile(z, [1, 99])
    span = max(hi - lo, 1e-3)
    return max(lo - margin * span, 1e-3), hi + margin * span


def dense_reconstruct(rec, images: dict, workspace: str | None = None,
                      opts: DenseOptions = DenseOptions(), seed: int = 0,
                      device=None) -> dict:
    """Multi-view stereo over all registered images of `rec` that have
    an image, then fusion.

    images: image_id -> (H, W) float grayscale (undistorted). Returns the
    fused point cloud dict (fusion.fuse); with `workspace`, also writes
    COLMAP-format depth and normal maps and fused.ply under it."""
    dev = devmod.resolve(device)
    gen = torch.Generator().manual_seed(seed)

    def T(a):
        return torch.as_tensor(np.asarray(a), dtype=DENSE_DTYPE, device=dev)

    reg = [i for i in rec.reg_image_ids if i in images]
    depth_maps, normal_maps = {}, {}
    for ref_id in reg:
        srcs = [s for s in select_source_images(rec, ref_id,
                                                opts.max_src_images)
                if s in images]
        if not srcs:
            continue
        K_r, R_r, t_r = _K_R_t(rec, ref_id)
        K_s, R_rel, t_rel = [], [], []
        for s in srcs:
            K2, R2, t2 = _K_R_t(rec, s)
            Rr = R2 @ R_r.T
            K_s.append(K2)
            R_rel.append(Rr)
            t_rel.append(t2 - Rr @ t_r)
        dmin, dmax = depth_range(rec, ref_id, opts.depth_margin)
        depth, normal, _ = pm.estimate_depth_map(
            gen, T(images[ref_id]), T(np.stack([images[s] for s in srcs])),
            T(K_r), T(np.stack(K_s)), T(np.stack(R_rel)), T(np.stack(t_rel)),
            float(dmin), float(dmax), opts.patch_match)
        depth_maps[ref_id] = depth
        normal_maps[ref_id] = normal
        if workspace is not None:
            name = rec.images[ref_id].name
            mvs_io.write_map_bin(mvs_io.depth_map_path(workspace, name),
                                 depth.cpu().numpy())
            mvs_io.write_map_bin(mvs_io.normal_map_path(workspace, name),
                                 normal.cpu().numpy())

    order = sorted(depth_maps)
    cams = [_K_R_t(rec, i) for i in order]
    fused = fusion.fuse([depth_maps[i] for i in order],
                        [normal_maps[i] for i in order],
                        [images[i] for i in order],
                        [c[0] for c in cams], [c[1] for c in cams],
                        [c[2] for c in cams], opts.fusion, device=dev)
    if workspace is not None and len(fused["xyz"]):
        mvs_io.write_ply_points(os.path.join(workspace, "fused.ply"),
                                fused["xyz"], fused["normal"],
                                fused["color"])
    return fused
