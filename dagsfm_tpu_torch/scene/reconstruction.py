"""Reconstruction containers.

Port of dagsfm_tpu/scene/reconstruction.py: `Reconstruction` is host
state (numpy + dicts) with the dynamic operations incremental SfM needs;
`SceneArrays` is its fixed-shape tensor view on a device, made by
`to_arrays`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch.device import DTYPE
from dagsfm_tpu_torch.scene import cameras as cm


class SceneArrays(NamedTuple):
    """Tensor view of a reconstruction (field layout as the reference):
    cam_model_id (C,) int32, cam_params (C, 12), image_qvec (I, 4) wxyz
    world->cam, image_tvec (I, 3), image_camidx (I,) int32, image_mask
    (I,) bool, points_xyz (P, 3), points_mask (P,), obs_image (N,) int32,
    obs_point (N,) int32, obs_xy (N, 2), obs_mask (N,)."""
    cam_model_id: torch.Tensor
    cam_params: torch.Tensor
    image_qvec: torch.Tensor
    image_tvec: torch.Tensor
    image_camidx: torch.Tensor
    image_mask: torch.Tensor
    points_xyz: torch.Tensor
    points_mask: torch.Tensor
    obs_image: torch.Tensor
    obs_point: torch.Tensor
    obs_xy: torch.Tensor
    obs_mask: torch.Tensor


_INT_FIELDS = ("cam_model_id", "image_camidx", "obs_image", "obs_point")
_BOOL_FIELDS = ("image_mask", "points_mask", "obs_mask")


def scene_arrays_from_numpy(fields: dict, device) -> SceneArrays:
    """SceneArrays from a dict of host arrays named as the fields."""
    out = {}
    for name in SceneArrays._fields:
        a = np.asarray(fields[name])
        if name in _INT_FIELDS:
            out[name] = torch.as_tensor(a.astype(np.int32), device=device)
        elif name in _BOOL_FIELDS:
            out[name] = torch.as_tensor(a.astype(bool), device=device)
        else:
            out[name] = torch.as_tensor(a, dtype=DTYPE, device=device)
    return SceneArrays(**out)


@dataclasses.dataclass
class ImageRecord:
    image_id: int
    name: str
    camera_id: int
    qvec: np.ndarray          # (4,) wxyz, world->cam
    tvec: np.ndarray          # (3,)
    xys: np.ndarray           # (K, 2) keypoints
    point3D_ids: np.ndarray   # (K,) int64, -1 = not triangulated
    registered: bool = False
    cluster_id: int = -1

    def num_points3D(self) -> int:
        return int(np.sum(self.point3D_ids >= 0))


@dataclasses.dataclass
class Point3DRecord:
    xyz: np.ndarray            # (3,)
    color: np.ndarray          # (3,) uint8
    error: float
    track: list                # list[(image_id, point2D_idx)]


class Reconstruction:
    """Host scene container with COLMAP semantics."""

    def __init__(self):
        self.cameras: dict[int, cm.Camera] = {}
        self.images: dict[int, ImageRecord] = {}
        self.points3D: dict[int, Point3DRecord] = {}
        self._next_point3D_id = 1

    def add_camera(self, camera: cm.Camera) -> None:
        assert camera.camera_id not in self.cameras
        self.cameras[camera.camera_id] = camera

    def add_image(self, image: ImageRecord) -> None:
        assert image.image_id not in self.images
        self.images[image.image_id] = image

    def add_point3D(self, xyz, track, color=None, error=-1.0) -> int:
        pid = self._next_point3D_id
        self._next_point3D_id += 1
        color = (np.zeros(3, np.uint8) if color is None
                 else np.asarray(color, np.uint8))
        self.points3D[pid] = Point3DRecord(np.asarray(xyz, np.float64), color,
                                           float(error), list(track))
        for image_id, p2d_idx in track:
            self.images[image_id].point3D_ids[p2d_idx] = pid
        return pid

    def add_observation(self, point3D_id: int, image_id: int,
                        p2d_idx: int) -> None:
        self.points3D[point3D_id].track.append((image_id, p2d_idx))
        self.images[image_id].point3D_ids[p2d_idx] = point3D_id

    def delete_point3D(self, point3D_id: int) -> None:
        for image_id, p2d_idx in self.points3D[point3D_id].track:
            img = self.images.get(image_id)
            if img is not None and img.point3D_ids[p2d_idx] == point3D_id:
                img.point3D_ids[p2d_idx] = -1
        del self.points3D[point3D_id]

    def delete_observation(self, point3D_id: int, image_id: int,
                           p2d_idx: int) -> None:
        pt = self.points3D[point3D_id]
        pt.track = [(i, k) for (i, k) in pt.track
                    if not (i == image_id and k == p2d_idx)]
        self.images[image_id].point3D_ids[p2d_idx] = -1
        if len(pt.track) < 2:
            self.delete_point3D(point3D_id)

    def register_image(self, image_id: int) -> None:
        self.images[image_id].registered = True

    def deregister_image(self, image_id: int) -> None:
        img = self.images[image_id]
        for p2d_idx, pid in enumerate(img.point3D_ids):
            if pid >= 0:
                self.delete_observation(int(pid), image_id, p2d_idx)
        img.registered = False

    def filter_images(self, min_focal_length_ratio: float = 0.1,
                      max_focal_length_ratio: float = 10.0,
                      max_extra_param: float = 100.0) -> list:
        """Deregister images whose camera has bogus intrinsics (COLMAP
        Reconstruction::FilterImages). Returns the deregistered ids."""
        bad_cams = set()
        for cid, cam in self.cameras.items():
            ratio = cam.focal() / max(cam.width, cam.height)
            n_intr = 3 if cam.model_id in cm._SINGLE_FOCAL else 4
            extra = np.abs(np.asarray(cam.params[n_intr:], float))
            if (ratio < min_focal_length_ratio
                    or ratio > max_focal_length_ratio
                    or (extra.size and extra.max() > max_extra_param)):
                bad_cams.add(cid)
        filtered = [i for i in self.reg_image_ids
                    if self.images[i].camera_id in bad_cams]
        for iid in filtered:
            self.deregister_image(iid)
        return filtered

    @property
    def reg_image_ids(self) -> list:
        return [i for i, im in self.images.items() if im.registered]

    def num_reg_images(self) -> int:
        return len(self.reg_image_ids)

    def num_points3D(self) -> int:
        return len(self.points3D)

    def compute_mean_reprojection_error(self) -> float:
        errs, w = 0.0, 0
        for pt in self.points3D.values():
            if pt.error >= 0:
                errs += pt.error * len(pt.track)
                w += len(pt.track)
        return errs / max(w, 1)

    def to_arrays(self, device, max_obs: int | None = None) -> tuple:
        """SceneArrays on `device` + (cam_ids, img_ids, pt_ids) orders."""
        cam_ids = sorted(self.cameras)
        img_ids = sorted(self.images)
        pt_ids = sorted(self.points3D)
        cam_index = {c: k for k, c in enumerate(cam_ids)}
        img_index = {i: k for k, i in enumerate(img_ids)}
        pt_index = {p: k for k, p in enumerate(pt_ids)}
        C, I, P = len(cam_ids), len(img_ids), len(pt_ids)
        cam_params = np.zeros((C, cm.MAX_CAMERA_PARAMS))
        for k, c in enumerate(cam_ids):
            p = np.asarray(self.cameras[c].params)
            cam_params[k, : len(p)] = p
        obs = [(img_index[i], pt_index[p], self.images[i].xys[k])
               for p in pt_ids for (i, k) in self.points3D[p].track
               if self.images[i].registered]
        n = max_obs if max_obs is not None else len(obs)
        assert n >= len(obs), (n, len(obs))
        obs_image = np.zeros(n, np.int32)
        obs_point = np.zeros(n, np.int32)
        obs_xy = np.zeros((n, 2))
        obs_mask = np.zeros(n, bool)
        for k, (ii, pp, xy) in enumerate(obs):
            obs_image[k], obs_point[k], obs_xy[k] = ii, pp, xy
            obs_mask[k] = True
        fields = dict(
            cam_model_id=[self.cameras[c].model_id for c in cam_ids],
            cam_params=cam_params,
            image_qvec=(np.stack([self.images[i].qvec for i in img_ids])
                        if I else np.zeros((0, 4))),
            image_tvec=(np.stack([self.images[i].tvec for i in img_ids])
                        if I else np.zeros((0, 3))),
            image_camidx=[cam_index[self.images[i].camera_id]
                          for i in img_ids],
            image_mask=[self.images[i].registered for i in img_ids],
            points_xyz=(np.stack([self.points3D[p].xyz for p in pt_ids])
                        if P else np.zeros((0, 3))),
            points_mask=np.ones(P, bool),
            obs_image=obs_image, obs_point=obs_point, obs_xy=obs_xy,
            obs_mask=obs_mask)
        return scene_arrays_from_numpy(fields, device), (cam_ids, img_ids,
                                                         pt_ids)
