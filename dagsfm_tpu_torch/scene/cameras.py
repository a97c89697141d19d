"""Camera models: the pinhole pair (SIMPLE_PINHOLE, PINHOLE).

Port of the slice-1 part of dagsfm_tpu/scene/cameras.py: the model id
table (COLMAP numbering, shared with the reference so files
interoperate), `Camera`, `make_simple_camera`, `img_from_cam` /
`cam_from_img` for the two pinhole models, and
`intrinsics_refine_mask`. The nine distortion models wait; asking for
one raises instead of projecting wrongly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_CAMERA_PARAMS = 12

SIMPLE_PINHOLE = 0
PINHOLE = 1
SIMPLE_RADIAL = 2
RADIAL = 3
OPENCV = 4
OPENCV_FISHEYE = 5
FULL_OPENCV = 6
FOV = 7
SIMPLE_RADIAL_FISHEYE = 8
RADIAL_FISHEYE = 9
THIN_PRISM_FISHEYE = 10

CAMERA_MODEL_NAMES = {
    SIMPLE_PINHOLE: "SIMPLE_PINHOLE",
    PINHOLE: "PINHOLE",
    SIMPLE_RADIAL: "SIMPLE_RADIAL",
    RADIAL: "RADIAL",
    OPENCV: "OPENCV",
    OPENCV_FISHEYE: "OPENCV_FISHEYE",
    FULL_OPENCV: "FULL_OPENCV",
    FOV: "FOV",
    SIMPLE_RADIAL_FISHEYE: "SIMPLE_RADIAL_FISHEYE",
    RADIAL_FISHEYE: "RADIAL_FISHEYE",
    THIN_PRISM_FISHEYE: "THIN_PRISM_FISHEYE",
}
CAMERA_MODEL_IDS = {v: k for k, v in CAMERA_MODEL_NAMES.items()}

CAMERA_MODEL_NUM_PARAMS = {
    SIMPLE_PINHOLE: 3, PINHOLE: 4, SIMPLE_RADIAL: 4, RADIAL: 5, OPENCV: 8,
    OPENCV_FISHEYE: 8, FULL_OPENCV: 12, FOV: 5, SIMPLE_RADIAL_FISHEYE: 4,
    RADIAL_FISHEYE: 5, THIN_PRISM_FISHEYE: 12,
}

# models whose params start (f, cx, cy, ...) instead of (fx, fy, cx, cy, ...)
_SINGLE_FOCAL = (SIMPLE_PINHOLE, SIMPLE_RADIAL, SIMPLE_RADIAL_FISHEYE,
                 RADIAL, RADIAL_FISHEYE)
PINHOLE_MODELS = (SIMPLE_PINHOLE, PINHOLE)
NUM_INTRINSIC_SLOTS = 8


def _check_pinhole(model_id) -> torch.Tensor:
    mid = torch.as_tensor(model_id)
    if not bool(torch.isin(mid, torch.tensor(PINHOLE_MODELS,
                                             device=mid.device)).all()):
        raise NotImplementedError(
            "only SIMPLE_PINHOLE and PINHOLE cameras are ported")
    return mid


def focal_and_pp(model_id, params: torch.Tensor) -> torch.Tensor:
    """(..., 4) = (fx, fy, cx, cy) from padded params (..., 12)."""
    single = torch.as_tensor(model_id, device=params.device) == SIMPLE_PINHOLE
    s = torch.stack([params[..., 0], params[..., 0], params[..., 1],
                     params[..., 2]], -1)
    d = params[..., :4]
    return torch.where(single[..., None], s, d)


def img_from_cam(model_id, params: torch.Tensor, xyz: torch.Tensor):
    """Camera-frame point(s) (..., 3) -> pixels (..., 2); z is clamped
    away from 0, callers mask by cheirality."""
    _check_pinhole(model_id)
    z = xyz[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    uv = xyz[..., :2] / zs[..., None]
    f = focal_and_pp(model_id, params)
    return uv * f[..., :2] + f[..., 2:]


def cam_from_img(model_id, params: torch.Tensor, xy: torch.Tensor):
    """Pixels (..., 2) -> normalized coords. For the pinhole models the
    reference's fixed-point undistortion is the identity after one step,
    so this is the closed form."""
    _check_pinhole(model_id)
    f = focal_and_pp(model_id, params)
    return (xy - f[..., 2:]) / f[..., :2]


def intrinsics_refine_mask(model_ids, refine_focal: bool,
                           refine_principal: bool, refine_extra: bool,
                           eligible=None, eligible_extra=None):
    """(C, 8) float mask of refinable intrinsic slots (host numpy, as the
    reference's 8-slot increment layout)."""
    mids = np.asarray(model_ids)
    C = mids.shape[0]
    single = np.isin(mids, _SINGLE_FOCAL)
    npar = np.vectorize(CAMERA_MODEL_NUM_PARAMS.get)(mids) if C else \
        np.zeros(0, int)
    n_extra = npar - np.where(single, 3, 4)
    mask = np.zeros((C, NUM_INTRINSIC_SLOTS), np.float64)
    if refine_focal:
        mask[:, 0] = 1.0
        mask[:, 1] = (~single).astype(np.float64)
    if refine_principal:
        mask[:, 2:4] = 1.0
    if eligible is not None:
        mask *= np.asarray(eligible, bool)[:, None].astype(np.float64)
    if refine_extra:
        if eligible_extra is None:
            eligible_extra = eligible
        ex = (np.ones(C, bool) if eligible_extra is None
              else np.asarray(eligible_extra, bool))
        for k in range(4):
            mask[:, 4 + k] = (n_extra > k) * ex
    return mask


class Camera(NamedTuple):
    """Host camera record; prior_focal marks a trusted (EXIF / user)
    focal, which selects E over F in two-view verification and keeps the
    focal fixed in bundle adjustment."""
    camera_id: int
    model_id: int
    width: int
    height: int
    params: tuple
    prior_focal: bool = True

    @property
    def model_name(self) -> str:
        return CAMERA_MODEL_NAMES[self.model_id]

    def focal(self) -> float:
        return float(self.params[0])

    def calibration_matrix(self) -> np.ndarray:
        if self.model_id in _SINGLE_FOCAL:
            fx, fy, cx, cy = (self.params[0], self.params[0],
                              self.params[1], self.params[2])
        else:
            fx, fy, cx, cy = self.params[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def make_simple_camera(camera_id: int, width: int, height: int,
                       focal: float | None = None,
                       model: str = "SIMPLE_PINHOLE") -> Camera:
    """Default camera; focal=None takes the 1.2 * max-dim heuristic and
    leaves prior_focal False."""
    prior_focal = focal is not None
    if focal is None:
        focal = 1.2 * max(width, height)
    if model == "SIMPLE_PINHOLE":
        params = (focal, width / 2.0, height / 2.0)
    elif model == "PINHOLE":
        params = (focal, focal, width / 2.0, height / 2.0)
    else:
        raise NotImplementedError(f"camera model {model} is not ported")
    return Camera(camera_id, CAMERA_MODEL_IDS[model], width, height, params,
                  prior_focal=prior_focal)
