"""Batched projection and reprojection errors.

Port of dagsfm_tpu/ops/projection.py; reprojection goes through every
camera model (`cameras.img_from_cam`).
"""

from __future__ import annotations

import torch

from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.scene import cameras as cm


def world_to_cam(qvec, tvec, xyz):
    """X_c = R(q) @ X_w + t, broadcast over leading dims."""
    return rops.quat_rotate(qvec, xyz) + tvec


def project_simple(qvec, tvec, focal, pp, xyz):
    """Pinhole projection without distortion -> (pixels, depth)."""
    Xc = world_to_cam(qvec, tvec, xyz)
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    return Xc[..., :2] / zs[..., None] * focal + pp, z


def project_full(model_id, params, qvec, tvec, xyz):
    """Projection through any camera model (per-element model ids) ->
    (pixels, depth)."""
    Xc = world_to_cam(qvec, tvec, xyz)
    return cm.img_from_cam(model_id, params, Xc), Xc[..., 2]


def reproj_errors_obs(scene):
    """Per-observation reprojection error of a SceneArrays:
    (errors (N,), depths (N,), mask (N,))."""
    oi = scene.obs_image.long()
    q = scene.image_qvec[oi]
    t = scene.image_tvec[oi]
    cidx = scene.image_camidx.long()[oi]
    Xc = world_to_cam(q, t, scene.points_xyz[scene.obs_point.long()])
    proj = cm.img_from_cam(scene.cam_model_id[cidx], scene.cam_params[cidx],
                           Xc)
    err = torch.linalg.norm(proj - scene.obs_xy, dim=-1)
    mask = (scene.obs_mask & scene.image_mask[oi]
            & scene.points_mask[scene.obs_point.long()])
    return err, Xc[..., 2], mask


def mean_reproj_error(scene) -> torch.Tensor:
    err, depth, mask = reproj_errors_obs(scene)
    good = mask & (depth > 0)
    return torch.sum(torch.where(good, err, 0.0)) / torch.clamp(
        good.sum(), min=1)


def angular_error(qvec, tvec, xyz, ray):
    """Angle (radians) between an observed ray and the point's direction
    in the camera frame."""
    Xc = world_to_cam(qvec, tvec, xyz)
    Xc = Xc / torch.clamp(torch.linalg.norm(Xc, dim=-1, keepdim=True),
                          min=1e-12)
    r = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True),
                          min=1e-12)
    return torch.arccos(torch.clamp(torch.sum(Xc * r, dim=-1), -1.0, 1.0))


def triangulation_angles(q1, t1, q2, t2, xyz):
    """Angle (radians) at the 3D point between the two camera centers."""
    c1 = rops.camera_center(rops.quat_to_rotmat(q1), t1)
    c2 = rops.camera_center(rops.quat_to_rotmat(q2), t2)
    b1 = c1 - xyz
    b2 = c2 - xyz
    cos = torch.sum(b1 * b2, dim=-1) / torch.clamp(
        torch.linalg.norm(b1, dim=-1) * torch.linalg.norm(b2, dim=-1),
        min=1e-12)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))
