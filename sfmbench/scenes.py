"""Input generators of the benchmark, made from `--seed`.

The program's own generators may change; these may not, so each is a
frozen copy of the one it was taken from (commit 5eb83d2):

* `ring_scene`: `dagsfm_tpu_torch/scene/synthetic.py` `_look_at` and
  `generate` (pinhole ring of cameras around a uniform point cloud,
  numpy RNG), without the options no cell uses; added: panorama
  stations, where an image shares the centre of the one before it and
  looks `panorama_yaw_deg` further round (a pure rotation between the
  two).
* `plant_features`: `chip_smoke.plant_features` (a base descriptor
  |N(0,1)|^128 per point, each observation the base plus N(0, noise),
  clipped at 0 and renormalised; visible points first, then distractors
  at random pixels with random descriptors), moved onto the device and
  drawn from a `torch.Generator` in a few large calls. Every slot after
  the visible points holds a distractor, as a full SIFT extraction fills
  its slots. Added: a share of the visible points' keypoints lie at a
  random pixel (a descriptor matched to the wrong place), so that the
  matches hold outliers as real matches do.
* `bal_truth` / `bal_start`: a problem at the shape of a BAL problem
  (cameras, points, observations and so the mean track length), drawn on
  the device: a ring of cameras looking into a ball of points, each point
  seen by a run of neighbouring cameras along the ring around the one
  nearest its azimuth, with track lengths spread as a geometric tail.

Nothing here imports the program: the runners turn these arrays into the
program's input types.
"""

from __future__ import annotations

import numpy as np
import torch


def _look_at(center, target, up=(0.0, 0.0, 1.0)):
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(z, np.asarray(up, np.float64))
    nx = np.linalg.norm(x)
    x = np.array([1.0, 0.0, 0.0]) if nx < 1e-9 else x / nx
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)
    return R, -R @ center


def ring_scene(num_cameras: int, num_points: int, width: int, height: int,
               focal: float, ring_radius: float = 10.0,
               ring_height_jitter: float = 1.0,
               point_cloud_extent: float = 4.0, pixel_noise: float = 0.0,
               min_track_length: int = 2, seed: int = 0,
               panorama_every: int = 0,
               panorama_yaw_deg: float = 0.0) -> dict:
    """The synthetic ring scene: R (I, 3, 3) world to camera, t (I, 3),
    points (P, 3), visible (I, P) bool, pixels (I, P, 2) with noise,
    and the pinhole (f, cx, cy). With panorama_every = n > 0, each image
    i with i % n == 1 keeps the centre of image i - 1 and turns its view
    by panorama_yaw_deg about the vertical."""
    rng = np.random.default_rng(seed)
    P, I = num_points, num_cameras
    points = rng.uniform(-point_cloud_extent, point_cloud_extent,
                         size=(P, 3))
    Rs, ts, centers, looks = [], [], [], []
    for i in range(I):
        ang = 2.0 * np.pi * i / I
        center = np.array([
            ring_radius * np.cos(ang),
            ring_radius * np.sin(ang),
            rng.uniform(-ring_height_jitter, ring_height_jitter),
        ])
        target = rng.uniform(-0.5, 0.5, size=3)
        if panorama_every and i % panorama_every == 1:
            a = np.radians(panorama_yaw_deg)
            turn = np.array([[np.cos(a), -np.sin(a), 0.0],
                             [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
            center = centers[-1]
            target = center + turn @ (looks[-1] - center)
        centers.append(center)
        looks.append(target)
        R, t = _look_at(center, target)
        Rs.append(R)
        ts.append(t)
    R = np.stack(Rs)
    t = np.stack(ts)
    fx, cx, cy = focal, width / 2.0, height / 2.0
    Xc = np.einsum("nij,pj->npi", R, points) + t[:, None, :]
    z = Xc[..., 2]
    in_front = z > 0.2
    z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    uv = Xc[..., :2] / z_safe[..., None]
    pix = uv * fx + np.array([cx, cy])
    in_image = ((pix[..., 0] >= 0) & (pix[..., 0] < width)
                & (pix[..., 1] >= 0) & (pix[..., 1] < height))
    visible = in_front & in_image
    if pixel_noise > 0:
        pix = pix + rng.normal(0.0, pixel_noise, size=pix.shape)
    ok = visible.sum(axis=0) >= min_track_length
    visible = visible & ok[None, :]
    return dict(R=R, t=t, points=points, visible=visible, pixels=pix,
                pinhole=(fx, cx, cy))


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def plant_features(scene: dict, K: int, noise: float, seed: int,
                   device, displaced_share: float = 0.0) -> dict:
    """K keypoint slots per image on `device`: the visible points in point
    order, then distractors in every other slot. Each visible point's
    keypoint lies, with probability displaced_share, at a uniform random
    pixel instead of its projection (its descriptor is the point's).

    Returns kp (I, K, 2) float64 host pixels, desc (I, K, 128) bf16 on the
    device, mask (I, K) bool on the device (every slot set), and
    point_of_slot (I, K) int64 host, -1 for a distractor."""
    vis = np.asarray(scene["visible"])
    I, P = vis.shape
    n = vis.sum(1)
    if n.max() > K:
        raise ValueError(f"{int(n.max())} visible points > K={K}")
    W = 2.0 * scene["pinhole"][1]
    H = 2.0 * scene["pinhole"][2]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    base = _unit(torch.abs(torch.randn((P, 128), **f32)))
    ii, pp = np.nonzero(vis)
    slot = (np.cumsum(vis, axis=1) - 1)[ii, pp]
    desc = _unit(torch.abs(torch.randn((I, K, 128), **f32)))
    obs = base[torch.as_tensor(pp, device=device)] + noise * torch.randn(
        (len(pp), 128), **f32)
    ti, ts = (torch.as_tensor(a, device=device) for a in (ii, slot))
    desc[ti, ts] = _unit(torch.clamp(obs, min=0.0))
    kp = torch.rand((I, K, 2), dtype=torch.float64, device=device,
                    generator=g) * torch.tensor([W, H], dtype=torch.float64,
                                                device=device)
    moved = (torch.rand((len(pp),), dtype=torch.float64, device=device,
                        generator=g) < displaced_share).cpu().numpy()
    kp = kp.cpu().numpy()
    kp[ii[~moved], slot[~moved]] = scene["pixels"][ii[~moved], pp[~moved]]
    point_of_slot = np.full((I, K), -1, np.int64)
    point_of_slot[ii, slot] = pp
    displaced = np.zeros((I, K), bool)
    displaced[ii[moved], slot[moved]] = True
    return dict(kp=kp, desc=desc.to(torch.bfloat16).contiguous(),
                mask=torch.ones((I, K), dtype=torch.bool, device=device),
                point_of_slot=point_of_slot, displaced=displaced)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product (w, x, y, z)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def axis_angle_quat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 4) unit quaternions (w, x, y, z)."""
    a = torch.linalg.norm(w, dim=-1, keepdim=True)
    half = 0.5 * a
    k = torch.where(a > 1e-12, torch.sin(half) / torch.clamp(a, min=1e-300),
                    0.5 - a * a / 48.0)
    return torch.cat([torch.cos(half), w * k], -1)


def rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) (w, x, y, z), w >= 0, by the largest of the
    four diagonal forms."""
    R = np.asarray(R, np.float64)
    m = R.reshape(-1, 3, 3)
    out = np.empty((len(m), 4))
    for k, M in enumerate(m):
        tr = np.trace(M)
        c = [1.0 + tr, 1.0 + M[0, 0] - M[1, 1] - M[2, 2],
             1.0 - M[0, 0] + M[1, 1] - M[2, 2],
             1.0 - M[0, 0] - M[1, 1] + M[2, 2]]
        b = int(np.argmax(c))
        s = 2.0 * np.sqrt(c[b])
        if b == 0:
            q = [c[0], M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]
        elif b == 1:
            q = [M[2, 1] - M[1, 2], c[1], M[0, 1] + M[1, 0], M[0, 2] + M[2, 0]]
        elif b == 2:
            q = [M[0, 2] - M[2, 0], M[0, 1] + M[1, 0], c[2], M[1, 2] + M[2, 1]]
        else:
            q = [M[1, 0] - M[0, 1], M[0, 2] + M[2, 0], M[1, 2] + M[2, 1], c[3]]
        q = np.asarray(q) / s
        out[k] = (-q if q[0] < 0 else q) / np.linalg.norm(q)
    return out.reshape(R.shape[:-2] + (4,))


def bal_truth(num_cameras: int, num_points: int, num_observations: int,
              width: int, height: int, focal_factor: float,
              focal_spread: float, k1_range: tuple, k2_range: tuple,
              ring_radius: float, ring_height_jitter: float,
              ball_radius: float, pixel_noise: float, seed: int,
              device) -> dict:
    """A bundle adjustment problem of exactly the given counts, on
    `device`.

    Cameras on a ring of `ring_radius` look at points uniform in a ball
    of `ball_radius` at its centre; each camera is RADIAL (f, cx, cy, k1,
    k2) with f = focal_factor · width · (1 + U(-spread, spread)) and k1,
    k2 uniform in their ranges, the principal point at the centre.

    Tracks: each point is seen by 2 + e_p cameras, the e_p summing to
    num_observations - 2 P: the extra observations fall on the points in
    proportion to exponential weights (a geometric tail of long tracks,
    as in real collections), each track at most num_cameras long. A
    point's cameras are a run of neighbours along the ring centred on
    the camera nearest its azimuth, so that cameras share points with
    their neighbours only, as photos of a street or a square do.
    Observations are the projections plus N(0, pixel_noise). Returns
    qvec (I, 4), tvec (I, 3), intr (I, 5), points (P, 3), obs_image,
    obs_point (N,) int64 and obs_xy (N, 2),
    all float64 or int64 on `device`."""
    C, P, N = num_cameras, num_points, num_observations
    rng = np.random.default_rng(seed)
    Rs, ts = [], []
    for i in range(C):
        ang = 2.0 * np.pi * i / C
        center = np.array([ring_radius * np.cos(ang),
                           ring_radius * np.sin(ang),
                           rng.uniform(-ring_height_jitter,
                                       ring_height_jitter)])
        R, t = _look_at(center, rng.uniform(-0.5, 0.5, size=3))
        Rs.append(R)
        ts.append(t)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    R = torch.as_tensor(np.stack(Rs), **f64)
    t = torch.as_tensor(np.stack(ts), **f64)
    d = torch.randn((P, 3), generator=g, **f64)
    r = ball_radius * torch.rand((P, 1), generator=g, **f64) ** (1 / 3)
    points = d / torch.linalg.norm(d, dim=-1, keepdim=True) * r
    u = torch.rand((C, 3), generator=g, **f64)
    f = focal_factor * width * (1 + focal_spread * (2 * u[:, 0] - 1))
    k1 = k1_range[0] + (k1_range[1] - k1_range[0]) * u[:, 1]
    k2 = k2_range[0] + (k2_range[1] - k2_range[0]) * u[:, 2]
    intr = torch.stack([f, torch.full_like(f, width / 2.0),
                        torch.full_like(f, height / 2.0), k1, k2], -1)
    length = track_lengths(P, N, C, g, device)
    L = int(length.max())
    phi = torch.atan2(points[:, 1], points[:, 0])
    centre = torch.round(phi / (2 * np.pi) * C).long() % C
    off = torch.arange(L, device=device)[None, :] \
        - torch.div(length - 1, 2, rounding_mode="floor")[:, None]
    cams = (centre[:, None] + off) % C
    keep = torch.arange(L, device=device)[None, :] < length[:, None]
    obs_point = torch.arange(P, device=device)[:, None].expand(P, L)[keep]
    obs_image = cams[keep]
    Xc = torch.einsum("nij,nj->ni", R[obs_image], points[obs_point]) \
        + t[obs_image]
    obs_xy = project_radial(intr[obs_image], Xc) + pixel_noise * torch.randn(
        (len(obs_image), 2), generator=g, **f64)
    qvec = torch.as_tensor(rotmat_to_quat_np(np.stack(Rs)), **f64)
    return dict(qvec=qvec, tvec=t, intr=intr, points=points,
                obs_image=obs_image, obs_point=obs_point, obs_xy=obs_xy)


def track_lengths(P: int, N: int, C: int, g, device) -> torch.Tensor:
    """(P,) int64 track lengths, each 2 to C, summing to N: 2 each, and
    the N - 2 P extra observations drawn onto the points in proportion to
    exponential weights; what a cap at C cuts off goes one by one to
    shorter tracks in a seeded order."""
    if N < 2 * P or N > C * P:
        raise ValueError("observations outside 2 to num_cameras per point")
    w = -torch.log1p(-torch.rand((P,), generator=g, dtype=torch.float64,
                                 device=device))
    pick = torch.multinomial(w, N - 2 * P, replacement=True, generator=g)
    length = torch.clamp(2 + torch.bincount(pick, minlength=P), max=C)
    order = torch.randperm(P, generator=g, device=device)
    while True:
        left = N - int(length.sum())
        if left == 0:
            return length
        room = order[length[order] < C][:left]
        length[room] += 1


def project_radial(intr: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """RADIAL pixels of camera points Xc (..., 3); intr (..., 5) = f, cx,
    cy, k1, k2."""
    uv = Xc[..., :2] / Xc[..., 2:3]
    r2 = torch.sum(uv * uv, -1, keepdim=True)
    radial = 1.0 + r2 * (intr[..., 3:4] + intr[..., 4:5] * r2)
    return uv * radial * intr[..., 0:1] + intr[..., 1:3]


def bal_start(truth: dict, sigma: dict, held: int, seed: int,
              index: int) -> dict:
    """A seeded start for one solve: poses turned by N(0, rotation_rad)
    per axis and moved by N(0, translation), points moved by N(0,
    point), focal scaled by exp(N(0, log_focal)), k1 and k2 moved by
    N(0, k1) and N(0, k2). The first `held` images keep their true poses
    (they are held in the solve)."""
    dev = truth["points"].device
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 1_000_003 + index) % (2 ** 63))
    f64 = dict(dtype=torch.float64, device=dev, generator=g)
    I, P = truth["qvec"].shape[0], truth["points"].shape[0]
    dq = axis_angle_quat(sigma["rotation_rad"] * torch.randn((I, 3), **f64))
    dt = sigma["translation"] * torch.randn((I, 3), **f64)
    dq[:held] = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64, device=dev)
    dt[:held] = 0.0
    intr = truth["intr"].clone()
    intr[:, 0] = intr[:, 0] * torch.exp(
        sigma["log_focal"] * torch.randn((I,), **f64))
    intr[:, 3] = intr[:, 3] + sigma["k1"] * torch.randn((I,), **f64)
    intr[:, 4] = intr[:, 4] + sigma["k2"] * torch.randn((I,), **f64)
    return dict(qvec=quat_multiply(dq, truth["qvec"]),
                tvec=truth["tvec"] + dt, intr=intr,
                points=truth["points"] + sigma["point"] * torch.randn(
                    (P, 3), **f64))
