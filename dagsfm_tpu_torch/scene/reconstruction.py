"""Reconstruction containers.

Port of dagsfm_tpu/scene/reconstruction.py: `Reconstruction` is host
state (numpy + dicts) with the dynamic operations incremental SfM and
the cluster merge need; `SceneArrays` is its fixed-shape tensor view on
a device, made by `to_arrays` and written back by `update_from_arrays`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from dagsfm_tpu_torch.device import DTYPE
from dagsfm_tpu_torch.ops import rotations as rops
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

    def merge_points3D(self, pid1: int, pid2: int) -> int:
        """Merge pid2 into pid1 with a track-length-weighted position."""
        p1, p2 = self.points3D[pid1], self.points3D[pid2]
        n1, n2 = len(p1.track), len(p2.track)
        xyz = (p1.xyz * n1 + p2.xyz * n2) / (n1 + n2)
        color = ((p1.color.astype(np.int64) * n1
                  + p2.color.astype(np.int64) * n2)
                 // (n1 + n2)).astype(np.uint8)
        track = p1.track + p2.track
        for image_id, p2d_idx in p2.track:
            self.images[image_id].point3D_ids[p2d_idx] = pid1
        p1.xyz, p1.color, p1.track = xyz, color, track
        del self.points3D[pid2]
        return pid1

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

    def extract_colors(self, images: dict) -> int:
        """Colour each 3D point by the mean bilinear sample over the images
        that observe it. `images`: image_id -> (H, W) grey or (H, W, 3)
        RGB array in [0, 1]. Returns the number of points coloured."""
        acc = {pid: np.zeros(3) for pid in self.points3D}
        cnt = {pid: 0 for pid in self.points3D}
        for iid, img in images.items():
            if iid not in self.images:
                continue
            arr = np.asarray(img, np.float64)
            if arr.ndim == 2:
                arr = np.repeat(arr[:, :, None], 3, axis=2)
            h, w = arr.shape[:2]
            im = self.images[iid]
            for p2d_idx, pid in enumerate(im.point3D_ids):
                if pid < 0 or int(pid) not in acc:
                    continue
                x, y = im.xys[p2d_idx]
                if not (0 <= x <= w - 1 and 0 <= y <= h - 1):
                    continue
                x0, y0 = int(np.floor(min(x, w - 2))), \
                    int(np.floor(min(y, h - 2)))
                fx, fy = x - x0, y - y0
                c = ((1 - fx) * (1 - fy) * arr[y0, x0]
                     + fx * (1 - fy) * arr[y0, x0 + 1]
                     + (1 - fx) * fy * arr[y0 + 1, x0]
                     + fx * fy * arr[y0 + 1, x0 + 1])
                acc[int(pid)] += c
                cnt[int(pid)] += 1
        n = 0
        for pid, k in cnt.items():
            if k > 0:
                self.points3D[pid].color = np.clip(
                    acc[pid] / k * 255.0, 0, 255).astype(np.uint8)
                n += 1
        return n

    @property
    def reg_image_ids(self) -> list:
        return [i for i, im in self.images.items() if im.registered]

    def num_reg_images(self) -> int:
        return len(self.reg_image_ids)

    def num_points3D(self) -> int:
        return len(self.points3D)

    def find_common_reg_image_ids(self, other: "Reconstruction") -> list:
        """(my id, other's id) of every registered image name the two
        share, in other's order."""
        mine = {self.images[i].name: i for i in self.reg_image_ids}
        out = []
        for j in other.reg_image_ids:
            name = other.images[j].name
            if name in mine:
                out.append((mine[name], j))
        return out

    def compute_mean_reprojection_error(self) -> float:
        errs, w = 0.0, 0
        for pt in self.points3D.values():
            if pt.error >= 0:
                errs += pt.error * len(pt.track)
                w += len(pt.track)
        return errs / max(w, 1)

    def transform(self, scale: float, R: np.ndarray, t: np.ndarray) -> None:
        """Apply the Sim(3) x -> scale R x + t to the points and to the
        registered cameras' centres and orientations."""
        for pt in self.points3D.values():
            pt.xyz = scale * R @ pt.xyz + t
        for img in self.images.values():
            if not img.registered:
                continue
            Rcw = rops.quat_to_rotmat(torch.as_tensor(img.qvec)).numpy()
            C_new = scale * R @ (-Rcw.T @ img.tvec) + t
            R_new = Rcw @ R.T
            img.qvec = rops.rotmat_to_quat(torch.as_tensor(R_new)).numpy()
            img.tvec = -R_new @ C_new

    def merge(self, other: "Reconstruction", scale: float, R: np.ndarray,
              t: np.ndarray, max_reproj_error: float = 8.0) -> None:
        """Fold a copy of `other`, moved by the Sim(3), into self. Common
        images (by name) keep self's pose; other's new images keep their
        (database-global) id where it is free; a point of other seen in
        a common image where self already has a point joins that point,
        otherwise it is added with its observations that are free."""
        other = copy.deepcopy(other)
        other.transform(scale, R, t)
        name_to_self = {im.name: i for i, im in self.images.items()}
        common_other, new_other = [], []
        for j, im in other.images.items():
            (common_other if im.name in name_to_self else new_other).append(j)
        for cam_id, cam in other.cameras.items():
            if cam_id not in self.cameras:
                self.cameras[cam_id] = cam
        id_map = {}
        for j in new_other:
            im = other.images[j]
            new_id = j if j not in self.images else \
                max(self.images.keys(), default=0) + 1
            id_map[j] = new_id
            self.images[new_id] = dataclasses.replace(
                im, image_id=new_id,
                point3D_ids=np.full_like(im.point3D_ids, -1))
        for j in common_other:
            id_map[j] = name_to_self[other.images[j].name]
        for pt in other.points3D.values():
            track = []
            merge_into = None
            for (img_id, k) in pt.track:
                self_img_id = id_map[img_id]
                existing = self.images[self_img_id].point3D_ids[k]
                if img_id in common_other and existing >= 0:
                    merge_into = int(existing)
                elif existing < 0:
                    track.append((self_img_id, k))
            if merge_into is not None:
                for (img_id, k) in track:
                    self.add_observation(merge_into, img_id, k)
            elif len(track) >= 2:
                self.add_point3D(pt.xyz, track, pt.color, pt.error)

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

    def update_from_arrays(self, arrays: SceneArrays, ids) -> None:
        """Write a SceneArrays' camera params, poses and points back into
        the records (ids: to_arrays' orders)."""
        cam_ids, img_ids, pt_ids = ids
        host = (lambda a: a.detach().cpu().numpy())
        cp, q = host(arrays.cam_params), host(arrays.image_qvec)
        tv, X = host(arrays.image_tvec), host(arrays.points_xyz)
        for k, c in enumerate(cam_ids):
            n = cm.CAMERA_MODEL_NUM_PARAMS[self.cameras[c].model_id]
            self.cameras[c] = self.cameras[c]._replace(
                params=tuple(cp[k][:n].tolist()))
        for k, i in enumerate(img_ids):
            self.images[i].qvec = q[k]
            self.images[i].tvec = tv[k]
        for k, p in enumerate(pt_ids):
            self.points3D[p].xyz = X[k]
