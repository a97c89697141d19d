"""Deterministic synthetic scenes (numpy RNG: the same seed gives the same
scene as dagsfm_tpu/scene/synthetic.py).

Port of `SyntheticSceneSpec`, `generate`, `to_reconstruction`,
`to_matching_problem`, `to_scene_arrays`, `pose_errors` (and its Sim(3),
`align_to_truth`) and `render_images` (through the scene's pinhole
camera or any camera model).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.ops.umeyama import umeyama_np
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene.reconstruction import (ImageRecord, Reconstruction,
                                                   scene_arrays_from_numpy)
from dagsfm_tpu_torch.sfm.correspondence_graph import CorrespondenceGraph


@dataclasses.dataclass
class SyntheticSceneSpec:
    num_cameras: int = 20
    num_points: int = 500
    image_width: int = 1024
    image_height: int = 768
    focal: float = 1000.0
    ring_radius: float = 10.0
    ring_height_jitter: float = 1.0
    point_cloud_extent: float = 4.0
    pixel_noise: float = 0.0
    outlier_fraction: float = 0.0
    min_track_length: int = 2
    max_track_length: int = 0   # 0 = unlimited
    seed: int = 0
    camera_model: str = "SIMPLE_PINHOLE"


@dataclasses.dataclass
class SyntheticScene:
    spec: SyntheticSceneSpec
    R: np.ndarray          # (I, 3, 3) world->cam
    t: np.ndarray          # (I, 3)
    points: np.ndarray     # (P, 3)
    camera: cm.Camera
    visible: np.ndarray    # (I, P) bool
    pixels: np.ndarray     # (I, P, 2)
    is_outlier: np.ndarray  # (I, P) bool

    def look_dirs(self) -> np.ndarray:
        return self.R[:, 2, :]   # each camera's z-axis in the world frame

    def centers(self) -> np.ndarray:
        return np.einsum("nij,nj->ni", self.R.transpose(0, 2, 1), -self.t)


def _look_at(center, target, up=(0.0, 0.0, 1.0)):
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(z, np.asarray(up, np.float64))
    nx = np.linalg.norm(x)
    x = np.array([1.0, 0.0, 0.0]) if nx < 1e-9 else x / nx
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)
    return R, -R @ center


def generate(spec: SyntheticSceneSpec) -> SyntheticScene:
    rng = np.random.default_rng(spec.seed)
    P, I = spec.num_points, spec.num_cameras
    points = rng.uniform(-spec.point_cloud_extent, spec.point_cloud_extent,
                         size=(P, 3))
    Rs, ts = [], []
    for i in range(I):
        ang = 2.0 * np.pi * i / I
        center = np.array([
            spec.ring_radius * np.cos(ang),
            spec.ring_radius * np.sin(ang),
            rng.uniform(-spec.ring_height_jitter, spec.ring_height_jitter),
        ])
        R, t = _look_at(center, rng.uniform(-0.5, 0.5, size=3))
        Rs.append(R)
        ts.append(t)
    R = np.stack(Rs)
    t = np.stack(ts)
    camera = cm.make_simple_camera(1, spec.image_width, spec.image_height,
                                   focal=spec.focal, model=spec.camera_model)
    Xc = np.einsum("nij,pj->npi", R, points) + t[:, None, :]
    z = Xc[..., 2]
    in_front = z > 0.2
    z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    uv = Xc[..., :2] / z_safe[..., None]
    fx, cx, cy = camera.params[0], camera.params[1], camera.params[2]
    pix = uv * fx + np.array([cx, cy])
    in_image = ((pix[..., 0] >= 0) & (pix[..., 0] < spec.image_width)
                & (pix[..., 1] >= 0) & (pix[..., 1] < spec.image_height))
    visible = in_front & in_image
    if spec.max_track_length > 0:
        score = rng.random(visible.shape)
        score[~visible] = np.inf
        order = np.argsort(score, axis=0)
        rank = np.empty_like(order)
        np.put_along_axis(
            rank, order,
            np.broadcast_to(np.arange(I)[:, None], visible.shape), axis=0)
        visible = visible & (rank < spec.max_track_length)
    if spec.pixel_noise > 0:
        pix = pix + rng.normal(0.0, spec.pixel_noise, size=pix.shape)
    is_outlier = np.zeros_like(visible)
    if spec.outlier_fraction > 0:
        flip = rng.random(visible.shape) < spec.outlier_fraction
        is_outlier = visible & flip
        rand_pix = np.stack([
            rng.uniform(0, spec.image_width, visible.shape),
            rng.uniform(0, spec.image_height, visible.shape),
        ], axis=-1)
        pix = np.where(is_outlier[..., None], rand_pix, pix)
    ok = visible.sum(axis=0) >= spec.min_track_length
    visible = visible & ok[None, :]
    is_outlier = is_outlier & ok[None, :]
    return SyntheticScene(spec=spec, R=R, t=t, points=points, camera=camera,
                          visible=visible, pixels=pix, is_outlier=is_outlier)


def to_reconstruction(scene: SyntheticScene,
                      with_points: bool = True) -> Reconstruction:
    """The ground-truth Reconstruction: every image registered, image i
    keypoint k the k-th point it sees (in point order), each point of a
    track of >= 2 views with its true position."""
    rec = Reconstruction()
    rec.add_camera(scene.camera)
    I, P = scene.visible.shape
    kp_index = np.full((I, P), -1, np.int64)
    qs = rops.rotmat_to_quat(torch.as_tensor(scene.R)).numpy()
    for i in range(I):
        vis = np.nonzero(scene.visible[i])[0]
        kp_index[i, vis] = np.arange(len(vis))
        rec.add_image(ImageRecord(
            image_id=i + 1, name=f"image{i + 1:05d}.jpg", camera_id=1,
            qvec=qs[i], tvec=scene.t[i].copy(), xys=scene.pixels[i, vis],
            point3D_ids=np.full(len(vis), -1, np.int64), registered=True))
    if with_points:
        # tracks assembled point-major from one stable sort of the
        # visible (image, point) pairs
        ii, pp = np.nonzero(scene.visible)
        kps = kp_index[ii, pp]
        order = np.argsort(pp, kind="stable")
        ii_s, pp_s, kp_s = ii[order], pp[order], kps[order]
        starts = np.searchsorted(pp_s, np.arange(P + 1))
        for p in range(P):
            a, b = starts[p], starts[p + 1]
            if b - a >= 2:
                rec.add_point3D(scene.points[p], list(zip(
                    (ii_s[a:b] + 1).tolist(), kp_s[a:b].tolist())))
    return rec


def to_scene_arrays(scene: SyntheticScene, device):
    """SyntheticScene -> SceneArrays on `device` (every visible
    observation of every point with a track of >= 2 views)."""
    I, P = scene.visible.shape
    pt_keep = scene.visible.sum(axis=0) >= max(2, scene.spec.min_track_length)
    ii, pp = np.nonzero(scene.visible & pt_keep[None, :])
    cam_params = np.zeros((1, cm.MAX_CAMERA_PARAMS))
    cam_params[0, : len(scene.camera.params)] = scene.camera.params
    return scene_arrays_from_numpy(dict(
        cam_model_id=[scene.camera.model_id], cam_params=cam_params,
        image_qvec=rops.rotmat_to_quat_np(scene.R), image_tvec=scene.t,
        image_camidx=np.zeros(I), image_mask=np.ones(I, bool),
        points_xyz=scene.points, points_mask=pt_keep,
        obs_image=ii, obs_point=pp, obs_xy=scene.pixels[ii, pp],
        obs_mask=np.ones(len(ii), bool)), device)


def _registered_centers(rec: Reconstruction, scene: SyntheticScene):
    ids, est_C, gt_C, est_R = [], [], [], []
    centers = scene.centers()
    for i, img in sorted(rec.images.items()):
        if not img.registered:
            continue
        k = i - 1
        Rcw = rops.quat_to_rotmat_np(img.qvec)
        est_R.append(Rcw)
        est_C.append(-Rcw.T @ img.tvec)
        gt_C.append(centers[k])
        ids.append(k)
    return ids, np.stack(est_C), np.stack(gt_C), np.stack(est_R)


def align_to_truth(rec: Reconstruction, scene: SyntheticScene) -> tuple:
    """(s, R, t): the Sim(3) that `pose_errors` fits, X_truth = s R X + t,
    by Umeyama on the registered camera centres (needs three)."""
    _, est_C, gt_C, _ = _registered_centers(rec, scene)
    return umeyama_np(est_C, gt_C)


def pose_errors(rec: Reconstruction, scene: SyntheticScene,
                align: bool = True) -> dict:
    """Rotation (deg) and center (ATE) errors against ground truth after a
    Sim(3) Umeyama alignment of the camera centers."""
    ids, est_C, gt_C, est_R = _registered_centers(rec, scene)
    s, Rsim, tsim = 1.0, np.eye(3), np.zeros(3)
    if align and len(ids) >= 3:
        s, Rsim, tsim = umeyama_np(est_C, gt_C)
    C_aligned = s * est_C @ Rsim.T + tsim
    ate = np.sqrt(np.mean(np.sum((C_aligned - gt_C) ** 2, axis=-1)))
    rot_errs = []
    for n, k in enumerate(ids):
        Rrel = (est_R[n] @ Rsim.T).T @ scene.R[k]
        cos = np.clip((np.trace(Rrel) - 1) / 2, -1, 1)
        rot_errs.append(np.degrees(np.arccos(cos)))
    return {"ate": float(ate), "rot_err_deg_mean": float(np.mean(rot_errs)),
            "rot_err_deg_max": float(np.max(rot_errs)), "num_reg": len(ids)}


def to_matching_problem(scene: SyntheticScene, match_outlier_fraction=0.0,
                        seed: int = 0):
    """(cameras, images, graph) as if features had been matched: keypoint
    k of image i is the k-th visible point, matches link keypoints of the
    same 3D point (pairs with >= 8 common points)."""
    rng = np.random.default_rng(seed)
    I, P = scene.visible.shape
    kp_index = np.full((I, P), -1, np.int64)
    images = {}
    for i in range(I):
        vis = np.nonzero(scene.visible[i])[0]
        kp_index[i, vis] = np.arange(len(vis))
        images[i + 1] = ImageRecord(
            image_id=i + 1, name=f"image{i + 1:05d}.jpg", camera_id=1,
            qvec=np.array([1.0, 0, 0, 0]), tvec=np.zeros(3),
            xys=scene.pixels[i, vis].copy(),
            point3D_ids=np.full(len(vis), -1, np.int64))
    graph = CorrespondenceGraph()
    for i in range(I):
        graph.add_image(i + 1, int(scene.visible[i].sum()))
    for i in range(I):
        for j in range(i + 1, I):
            common = np.nonzero(scene.visible[i] & scene.visible[j])[0]
            if len(common) < 8:
                continue
            m = np.stack([kp_index[i, common], kp_index[j, common]],
                         axis=1).astype(np.uint32)
            if match_outlier_fraction > 0:
                bad = rng.random(len(m)) < match_outlier_fraction
                m[bad, 1] = rng.integers(0, int(scene.visible[j].sum()),
                                         bad.sum())
            graph.add_matches(i + 1, j + 1, m)
    return {1: scene.camera}, images, graph


def render_images(scene: SyntheticScene, sphere_radius: float | None = None,
                  num_waves: int = 96, feature_px: float = 6.0,
                  background: float = 0.15, seed: int = 0,
                  camera=None, device=None) -> dict:
    """Ray-traced grayscale images of a procedurally textured sphere at
    the scene origin, seen from the scene's poses: a band-limited
    sum of random 3D cosine waves at the ray-sphere intersection, shaded
    by the surface normal. Returns {image_id (1-based): (H, W) float32
    numpy}. The texture is drawn from np.random.default_rng(seed) as the
    reference draws it; the rays are traced with torch in float64 on
    `device` (the GPU unless "cpu" is asked for). With `camera=` (any
    model, e.g. SIMPLE_RADIAL with k1 != 0) each pixel's ray is its
    undistorted normalized coordinate, one `cam_from_img` over the pixel
    grid: the image is the distorted view of the scene."""
    from dagsfm_tpu_torch import device as devmod
    dev = devmod.resolve(device)
    rng = np.random.default_rng(seed)
    I = scene.R.shape[0]
    H, W = scene.spec.image_height, scene.spec.image_width
    fx = scene.camera.params[0]
    cx, cy = scene.camera.params[1], scene.camera.params[2]
    if sphere_radius is None:
        sphere_radius = scene.spec.point_cloud_extent
    depth_near = max(scene.spec.ring_radius - sphere_radius, 1.0)
    lam_mid = feature_px * depth_near / fx
    kmag = 2 * np.pi / np.exp(rng.uniform(
        np.log(lam_mid * 0.5), np.log(lam_mid * 4.0), num_waves))
    kdir = rng.normal(size=(num_waves, 3))
    kdir /= np.linalg.norm(kdir, axis=1, keepdims=True)
    kvec = kdir * kmag[:, None]
    phase = rng.uniform(0, 2 * np.pi, num_waves)
    amp = rng.uniform(0.5, 1.0, num_waves) / np.sqrt(num_waves)

    T = (lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                   device=dev))
    ones = torch.ones((H, W), dtype=torch.float64, device=dev)
    if camera is not None:
        pix = torch.stack([T(np.arange(W))[None, :].expand(H, W),
                           T(np.arange(H))[:, None].expand(H, W)], -1)
        xy = cm.cam_from_img(camera.model_id,
                             T(camera.padded_params()), pix)
        dirs_cam = torch.cat([xy, ones[..., None]], -1)
    else:
        xs = (T(np.arange(W)) - cx) / fx
        ys = (T(np.arange(H)) - cy) / fx
        dirs_cam = torch.stack([xs[None, :].expand(H, W),
                                ys[:, None].expand(H, W), ones], -1)
    kvec_t, phase_t, amp_t = T(kvec), T(phase), T(amp)
    images = {}
    C_all = scene.centers()
    for i in range(I):
        d = dirs_cam @ T(scene.R[i])
        C = T(C_all[i])
        dd = torch.sum(d * d, -1)
        b = 2.0 * (d @ C)
        c0 = C @ C - sphere_radius ** 2
        disc = b * b - 4 * dd * c0
        hit = disc > 0
        tt = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * dd)
        hit &= tt > 0
        p = C + tt[..., None] * d
        tex = torch.cos(p @ kvec_t.T + phase_t) @ amp_t
        tex = 0.5 + 0.5 * tex / torch.max(torch.abs(tex))
        nrm = p / sphere_radius
        view = -d / torch.sqrt(dd)[..., None]
        shade = 0.6 + 0.4 * torch.clamp(torch.sum(nrm * view, -1), 0, 1)
        img = torch.where(hit, tex * shade, torch.full_like(tex, background))
        images[i + 1] = img.to(torch.float32).cpu().numpy()
    return images
