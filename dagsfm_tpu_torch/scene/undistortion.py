"""Image and reconstruction undistortion, stereo rectification.

Port of dagsfm_tpu/scene/undistortion.py: the undistorted PINHOLE camera
of any of the eleven models, a reconstruction's cameras and keypoints
rewritten to it, the image warp to it, and planar rectification of a
stereo pair. The reference computes the model's distortion on its device
and then copies the source coordinates to the host and back; here the
whole warp stays on the device, in float64 coordinates over the float32
image (the reference's promotion). Images come back as numpy arrays, as
the reference returns them.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene.reconstruction import Reconstruction


@dataclasses.dataclass
class UndistortOptions:
    blank_pixels: float = 0.0
    min_scale: float = 0.2
    max_scale: float = 2.0
    roi_min_x: float = 0.0
    roi_max_x: float = 1.0
    roi_min_y: float = 0.0
    roi_max_y: float = 1.0


def undistorted_camera(camera: cm.Camera,
                       opts: UndistortOptions = UndistortOptions()
                       ) -> cm.Camera:
    """PINHOLE camera of the same size and focal, principal point at the
    image centre (the reference's; `opts` is not read there either)."""
    K = camera.calibration_matrix()
    w, h = camera.width, camera.height
    params = (K[0, 0], K[1, 1], w / 2.0, h / 2.0)
    return cm.Camera(camera.camera_id, cm.PINHOLE, w, h, params)


def _warp_bilinear(img: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at (ys, xs), 0 outside [0, H-1] x [0, W-1]."""
    H, W = img.shape
    y0 = torch.clamp(torch.floor(ys), 0, H - 2).long()
    x0 = torch.clamp(torch.floor(xs), 0, W - 2).long()
    dy = ys - y0
    dx = xs - x0
    img = img.to(ys.dtype)
    out = (img[y0, x0] * (1 - dy) * (1 - dx) + img[y0, x0 + 1] * (1 - dy) * dx
           + img[y0 + 1, x0] * dy * (1 - dx) + img[y0 + 1, x0 + 1] * dy * dx)
    inside = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
    return torch.where(inside, out, 0.0)


def _image(img, device) -> torch.Tensor:
    """The image as float32 on `device` (the reference's cast)."""
    return torch.as_tensor(np.asarray(img, np.float32), device=device)


def undistort_image(img, camera: cm.Camera,
                    new_camera: cm.Camera | None = None,
                    device=None) -> np.ndarray:
    """Warp a grayscale image to its undistorted pinhole view: every
    undistorted pixel goes through the source camera's distortion to the
    source pixel it samples (bilinear)."""
    dev = devmod.resolve(device)
    if new_camera is None:
        new_camera = undistorted_camera(camera)
    H, W = np.shape(img)
    Kn = new_camera.calibration_matrix()
    f64 = torch.float64
    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    uv = torch.stack([((xs - Kn[0, 2]) / Kn[0, 0]).reshape(-1),
                      ((ys - Kn[1, 2]) / Kn[1, 1]).reshape(-1)], -1)
    params = cm.pad_params(camera.params, camera.model_id).to(dev)
    duv = cm.distort(camera.model_id, params, uv)
    f = cm.focal_and_pp(camera.model_id, params)
    pix = duv * f[:2] + f[2:]
    out = _warp_bilinear(_image(img, dev), pix[:, 1].reshape(H, W),
                         pix[:, 0].reshape(H, W))
    return out.cpu().numpy()


def undistort_reconstruction(rec: Reconstruction,
                             device=None) -> Reconstruction:
    """Cameras rewritten to PINHOLE and keypoints to undistorted pixels
    (COLMAP's undistorter on the sparse model)."""
    dev = devmod.resolve(device)
    out = copy.deepcopy(rec)
    new_cams = {cid: undistorted_camera(cam)
                for cid, cam in rec.cameras.items()}
    for im in out.images.values():
        cam = rec.cameras[im.camera_id]
        if cam.model_id in cm.PINHOLE_MODELS:
            continue
        params = cm.pad_params(cam.params, cam.model_id).to(dev)
        uv = cm.cam_from_img(cam.model_id, params,
                             devmod.as_tensor(im.xys, dev))
        Kn = new_cams[im.camera_id].calibration_matrix()
        im.xys = uv.cpu().numpy() * np.array([Kn[0, 0], Kn[1, 1]]) \
            + Kn[:2, 2]
    out.cameras = new_cams
    return out


# ------------------------------------------------------ stereo rectification

def _rotmat(aa: np.ndarray) -> np.ndarray:
    return rops.angleaxis_to_rotmat(torch.as_tensor(aa)).numpy()


def rectify_stereo_cameras(camera1: cm.Camera, camera2: cm.Camera,
                           qvec: np.ndarray, tvec: np.ndarray):
    """Planar rectification of a calibrated (SIMPLE_)PINHOLE pair: the
    relative rotation split evenly between the views, the baseline turned
    onto the x-axis. Returns the homographies H1, H2 and the
    disparity-to-depth matrix Q (host numpy)."""
    if camera1.model_id not in cm.PINHOLE_MODELS or \
            camera2.model_id not in cm.PINHOLE_MODELS:
        raise ValueError("rectify_stereo_cameras needs (SIMPLE_)PINHOLE "
                         "cameras; undistort first")
    aa = rops.quat_to_angleaxis(torch.as_tensor(np.asarray(qvec, float)))
    R2 = _rotmat(-0.5 * aa.numpy())
    R1 = R2.T
    t = R2 @ np.asarray(tvec, float)
    x_unit = np.array([1.0, 0.0, 0.0])
    if t @ x_unit < 0:
        x_unit = -x_unit
    axis = np.cross(t, x_unit)
    if np.linalg.norm(axis) < 1e-15:
        R_x = np.eye(3)
    else:
        angle = np.arccos(abs(t @ x_unit) / np.linalg.norm(t))
        axis = axis / np.linalg.norm(axis)
        R_x = _rotmat(axis * angle)
    R1 = R_x @ R1
    R2 = R_x @ R2
    t = R_x @ t
    K1 = camera1.calibration_matrix()
    K2 = camera2.calibration_matrix()
    K = np.eye(3)
    K[0, 0] = K[1, 1] = min((K1[0, 0] + K1[1, 1]) / 2,
                            (K2[0, 0] + K2[1, 1]) / 2)
    K[0, 2] = K1[0, 2]
    K[1, 2] = (K1[1, 2] + K2[1, 2]) / 2
    H1 = K @ R1 @ np.linalg.inv(K1)
    H2 = K @ R2 @ np.linalg.inv(K2)
    Q = np.eye(4)
    Q[3, 0] = -K[1, 2]
    Q[3, 1] = -K[0, 2]
    Q[3, 2] = K[0, 0]
    Q[2, 3] = -1.0 / t[0]
    Q[3, 3] = 0.0
    return H1, H2, Q


def warp_image_with_homography(img, H, out_shape=None,
                               device=None) -> np.ndarray:
    """Inverse warp by H: out(x) = img(H⁻¹ x), bilinear, on the device."""
    dev = devmod.resolve(device)
    Hh, Ww = out_shape or np.shape(img)
    Hi = devmod.as_tensor(np.linalg.inv(np.asarray(H, float)), dev)
    f64 = torch.float64
    ys, xs = torch.meshgrid(torch.arange(Hh, dtype=f64, device=dev),
                            torch.arange(Ww, dtype=f64, device=dev),
                            indexing="ij")
    pts = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(Hh * Ww, dtype=f64, device=dev)])
    src = Hi @ pts
    sx = (src[0] / src[2]).reshape(Hh, Ww)
    sy = (src[1] / src[2]).reshape(Hh, Ww)
    return _warp_bilinear(_image(img, dev), sy, sx).cpu().numpy()


def rectify_and_undistort_stereo_pair(img1, img2, camera1, camera2,
                                      qvec, tvec, device=None):
    """Undistort both images to pinhole, then apply the rectifying
    homographies. Returns (rect1, rect2, Q)."""
    uc1 = undistorted_camera(camera1)
    uc2 = undistorted_camera(camera2)
    u1 = undistort_image(img1, camera1, uc1, device=device)
    u2 = undistort_image(img2, camera2, uc2, device=device)
    H1, H2, Q = rectify_stereo_cameras(uc1, uc2, qvec, tvec)
    return (warp_image_with_homography(u1, H1, device=device),
            warp_image_with_homography(u2, H2, device=device), Q)
