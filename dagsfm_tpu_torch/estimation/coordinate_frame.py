"""Coordinate-frame estimation: gravity and Manhattan-world alignment.

Port of dagsfm_tpu/estimation/coordinate_frame.py (COLMAP's
estimators/coordinate_frame):

- ``find_best_consensus_axis``  (FindBestConsensusAxis)
- ``estimate_gravity_vector_from_image_orientation``
- ``estimate_manhattan_world_frame``  (EstimateManhattanWorldFrame)
- ``rotation_from_unit_vectors``  (RotationFromUnitVectors)

Edge evidence is a gradient-weighted Hough transform on the device:
Sobel gradients of the edge-padded image (`_sobel`: the
cross-correlation `lax.conv` computes, its taps added in XLA:CPU's
order), then each strong pixel's vote into its (theta, rho) bin. The
JAX package scatter-adds the votes; on a GPU `index_add_` adds with
atomics in no fixed order, so here the votes are sorted by bin and
summed in a fixed order (`ops/segment_sum`): the same
bits on every run. Peak picking, vanishing points and the consensus run
on the host in numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.ops.segment_sum import segment_sum, segments

# torch.quantile refuses inputs of more than 2**24 elements: the default
# max_image_size of 1024 keeps an image at 1024 x 1024 = 2**20 at most
QUANTILE_MAX_ELEMS = 1 << 24


# --------------------------------------------------------------- consensus


def find_best_consensus_axis(axes, max_distance: float = 0.05) -> np.ndarray:
    """The axis with most inliers (1 - dot <= max_distance; ties to the
    smallest inlier distance sum), returned as its inliers' mean."""
    A = np.asarray(axes, float)
    if A.size == 0:
        return np.zeros(3)
    D = 1.0 - A @ A.T                       # (n, n) pairwise distances
    inl = (D <= max_distance)
    np.fill_diagonal(inl, True)
    counts = inl.sum(axis=1)
    sums = np.where(inl, D, 0.0).sum(axis=1)
    best = np.lexsort((sums, -counts))[0]
    sel = inl[best]
    axis = A[sel].sum(axis=0) / sel.sum()
    return axis


def estimate_gravity_vector_from_image_orientation(
        rec, max_axis_distance: float = 0.05) -> np.ndarray:
    """Consensus of the registered images' downward axes R.row(1)."""
    axes = []
    for iid in rec.reg_image_ids:
        R = np.asarray(rops.quat_to_rotmat_np(rec.images[iid].qvec))
        axes.append(R[1])
    return find_best_consensus_axis(axes, max_axis_distance)


def rotation_from_unit_vectors(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """The rotation matrix taking unit vector v1 onto v2 (Eigen's
    Quaterniond::FromTwoVectors)."""
    a = np.asarray(v1, float)
    a = a / np.linalg.norm(a)
    b = np.asarray(v2, float)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        # 180 degrees: about any axis orthogonal to a
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return rops.angleaxis_to_rotmat(
            torch.as_tensor(axis * np.pi, dtype=torch.float64)).numpy()
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


# ------------------------------------------------------- line detection


@dataclasses.dataclass
class ManhattanOptions:
    """COLMAP's ManhattanWorldFrameEstimationOptions."""
    max_image_size: int = 1024
    num_theta_bins: int = 60
    num_rho_bins: int = 128
    num_lines: int = 24
    min_line_support: float = 20.0
    vertical_tol_deg: float = 20.0       # line classification tolerance
    inlier_thresh: float = 0.02
    max_axis_distance: float = 0.05


def _sobel(img: torch.Tensor) -> tuple:
    """Sobel gradients (gx, gy) of the edge-padded image: the
    cross-correlation `lax.conv` computes with [[-1, 0, 1], [-2, 0, 2],
    [-1, 0, 1]] and its transpose, kernel not flipped. The taps are
    added in one fixed tree, the one XLA:CPU's convolution adds them in
    (the only one of the 945 trees over the six taps that gives its bits;
    each product by +-1 or +-2 is exact), so the gradients equal the JAX
    package's bit for bit on the CPU, and the card's elementwise adds
    round as the CPU's do. A convolution library sums in an order of its
    own, which decides the bins of pixels on a bin's edge."""
    h, w = img.shape
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]

    def t(i, j, k):
        return p[i:i + h, j:j + w] * k

    gx = ((t(0, 0, -1.0) + t(1, 2, 2.0))
          + ((t(0, 2, 1.0) + t(1, 0, -2.0)) + t(2, 0, -1.0))) + t(2, 2, 1.0)
    gy = ((t(0, 0, -1.0) + t(0, 1, -2.0))
          + (t(0, 2, -1.0) + (t(2, 0, 1.0) + t(2, 1, 2.0)))) + t(2, 2, 1.0)
    return gx, gy


def _hough_bins(img: torch.Tensor, num_theta: int, num_rho: int):
    """Each pixel's flat (theta, rho) bin and vote weight (|grad| above
    the 90th percentile of |grad|, else 0), all float32 as in the JAX
    package; and rho_max."""
    img = img.to(torch.float32)
    h, w = img.shape
    if h * w > QUANTILE_MAX_ELEMS:
        raise ValueError(f"hough: {h} x {w} image over torch.quantile's "
                         f"{QUANTILE_MAX_ELEMS} elements; lower "
                         "max_image_size")
    gx, gy = _sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    # orientation of the gradient = normal of the edge line, in [0, pi)
    theta = torch.remainder(torch.arctan2(gy, gx), torch.pi)
    ys, xs = torch.meshgrid(torch.arange(h, device=img.device),
                            torch.arange(w, device=img.device),
                            indexing="ij")
    rho = xs * torch.cos(theta) + ys * torch.sin(theta)
    rho_max = float(np.sqrt(float(h * h + w * w)))
    rm = torch.tensor(rho_max, dtype=torch.float32, device=img.device)
    t_idx = torch.clamp((theta / torch.pi * num_theta).to(torch.int32),
                        0, num_theta - 1)
    r_idx = torch.clamp(((rho + rm) / (2 * rm) * num_rho).to(torch.int32),
                        0, num_rho - 1)
    # suppress weak gradients so texture noise does not vote
    thresh = torch.quantile(mag.reshape(-1), 0.9)
    weight = torch.where(mag > thresh, mag, 0.0)
    key = t_idx.to(torch.int64) * num_rho + r_idx.to(torch.int64)
    return key.reshape(-1), weight.reshape(-1), rho_max


def _hough_accumulate(img: torch.Tensor, num_theta: int = 60,
                      num_rho: int = 128):
    """Gradient-weighted Hough accumulator: each pixel votes |grad| into
    its gradient-orientation bin at rho = x cos(theta) + y sin(theta).
    The votes are summed per bin in pixel order, in chunks
    (`segment_sum`): no atomics, the same bits on every run. Returns
    (acc (T, R) float32 on img's device, rho_max)."""
    key, weight, rho_max = _hough_bins(img, num_theta, num_rho)
    acc = segment_sum(weight, segments(key, num_theta * num_rho,
                                         key.device))
    return acc.reshape(num_theta, num_rho), rho_max


def detect_lines(img, opts: ManhattanOptions = None, device=None):
    """The top-K Hough peaks (3 x 3 non-max suppression, theta wraps) as
    lines. `img` (H, W) grayscale, numpy or a tensor; the accumulator is
    computed on `device` (the GPU unless "cpu" is asked for). Returns
    (lines (K, 3) homogeneous with unit normals, support (K,), theta
    (K,)) in pixel coordinates."""
    opts = opts or ManhattanOptions()
    dev = devmod.resolve(device)
    acc, rho_max = _hough_accumulate(
        torch.as_tensor(img, device=dev), opts.num_theta_bins,
        opts.num_rho_bins)
    return _lines_from_accumulator(acc.cpu().numpy(), rho_max, opts)


def _lines_from_accumulator(acc: np.ndarray, rho_max: float,
                            opts: ManhattanOptions):
    padded = np.pad(acc, ((1, 1), (1, 1)), mode="wrap")
    neigh = np.max(
        [padded[i:i + acc.shape[0], j:j + acc.shape[1]]
         for i in range(3) for j in range(3)], axis=0)
    peaks = np.where(acc >= neigh, acc, 0.0)
    flat = np.argsort(peaks.ravel())[::-1][:opts.num_lines]
    t_idx, r_idx = np.unravel_index(flat, acc.shape)
    support = peaks.ravel()[flat]
    keep = support > opts.min_line_support
    t_idx, r_idx, support = t_idx[keep], r_idx[keep], support[keep]
    theta = (t_idx + 0.5) / opts.num_theta_bins * np.pi
    rho = (r_idx + 0.5) / opts.num_rho_bins * 2 * rho_max - rho_max
    lines = np.stack([np.cos(theta), np.sin(theta), -rho], axis=1)
    return lines, support, theta


def estimate_vanishing_point(lines: np.ndarray, weights: np.ndarray,
                             inlier_thresh: float = 0.02,
                             focal: float = 1.0):
    """The best vanishing point over every pair of lines, scored by the
    weight of lines within inlier_thresh of it (|l . v| over focal, v
    scaled so its point part is in focal units). Lines have unit
    normals. Returns (vp (3,) or None, inlier mask)."""
    K = len(lines)
    if K < 2:
        return None, np.zeros(K, bool)
    ii, jj = np.triu_indices(K, 1)
    vps = np.cross(lines[ii], lines[jj])          # (P, 3)
    vn = vps / np.maximum(
        np.linalg.norm(vps[:, :2], axis=1, keepdims=True)
        + np.abs(vps[:, 2:]) / focal, 1e-12)
    res = np.abs(vn @ lines.T) / focal            # (P, K)
    inl = res < inlier_thresh
    score = (inl * weights[None, :]).sum(axis=1)
    best = int(np.argmax(score))
    if score[best] <= 0:
        return None, np.zeros(K, bool)
    return vps[best], inl[best]


def _image_on_device(img, max_image_size: int, dev) -> tuple:
    """(image as float32 on dev, strided down to max_image_size; the
    scale of the stride)."""
    x = torch.as_tensor(img, device=dev).to(torch.float32)
    m = max(x.shape)
    if m > max_image_size:
        step = int(np.ceil(m / max_image_size))
        return x[::step, ::step], 1.0 / step
    return x, 1.0


def estimate_manhattan_world_frame(rec, images: dict,
                                   opts: ManhattanOptions = None,
                                   cameras: dict = None,
                                   device=None) -> np.ndarray:
    """The Manhattan frame [right | down | forward] in world coordinates.

    `images` maps image_id -> grayscale array (numpy or a tensor). Per
    registered image: Hough lines on `device` -> near-vertical and
    horizontal lines by their normal's angle -> one vanishing point per
    class -> back through K^-1 and the image's rotation to the world ->
    consensus over the images."""
    opts = opts or ManhattanOptions()
    dev = devmod.resolve(device)
    down_axes, right_axes = [], []
    for iid in rec.reg_image_ids:
        if iid not in images:
            continue
        img, scale = _image_on_device(images[iid], opts.max_image_size, dev)
        im = rec.images[iid]
        cam = (cameras or rec.cameras)[im.camera_id]
        f = float(np.mean(cam.focal())) * scale if hasattr(cam, "focal") \
            else float(cam.params[0]) * scale
        cx, cy = img.shape[1] / 2.0, img.shape[0] / 2.0
        lines, support, theta = detect_lines(img, opts, device=dev)
        if len(lines) < 4:
            continue
        # lines in principal-point-centred coordinates:
        # l' = [a, b, c + a*cx + b*cy]
        lines_c = lines.copy()
        lines_c[:, 2] += lines[:, 0] * cx + lines[:, 1] * cy
        # vertical image lines have near-horizontal normals (theta ~ 0/pi)
        tol = np.deg2rad(opts.vertical_tol_deg)
        is_vert = np.minimum(theta, np.pi - theta) < tol
        R = np.asarray(rops.quat_to_rotmat_np(im.qvec))
        for mask, store, ref_dir in (
                (is_vert, down_axes, np.array([0.0, 1.0, 0.0])),
                (~is_vert, right_axes, np.array([1.0, 0.0, 0.0]))):
            if mask.sum() < 2:
                continue
            vp, _ = estimate_vanishing_point(
                lines_c[mask], support[mask], opts.inlier_thresh, f)
            if vp is None:
                continue
            d_cam = np.array([vp[0] / f, vp[1] / f, vp[2]])
            n = np.linalg.norm(d_cam)
            if n < 1e-9:
                continue
            d_cam /= n
            if d_cam @ ref_dir < 0:
                d_cam = -d_cam
            store.append(R.T @ d_cam)
    down = find_best_consensus_axis(down_axes, opts.max_axis_distance) \
        if down_axes else np.zeros(3)
    right = find_best_consensus_axis(right_axes, opts.max_axis_distance) \
        if right_axes else np.zeros(3)
    frame = np.zeros((3, 3))
    if np.linalg.norm(down) > 0:
        frame[:, 1] = down / np.linalg.norm(down)
    if np.linalg.norm(right) > 0:
        r = right
        if np.linalg.norm(down) > 0:      # orthogonalise against down
            r = r - (r @ frame[:, 1]) * frame[:, 1]
        if np.linalg.norm(r) > 1e-9:
            frame[:, 0] = r / np.linalg.norm(r)
    if np.linalg.norm(frame[:, 0]) > 0 and np.linalg.norm(frame[:, 1]) > 0:
        frame[:, 2] = np.cross(frame[:, 0], frame[:, 1])
    return frame


def align_to_manhattan_world(rec, frame: np.ndarray) -> np.ndarray:
    """The rotation model_orientation_aligner applies for a frame: the
    whole frame -> frame^T; one axis -> that axis onto its canonical
    direction."""
    if np.count_nonzero(frame[:, 0]) == 0:
        return rotation_from_unit_vectors(frame[:, 1], [0, 1, 0])
    if np.count_nonzero(frame[:, 1]) == 0:
        return rotation_from_unit_vectors(frame[:, 0], [1, 0, 0])
    return frame.T


# -------------------------------------------------- line segments


def detect_line_segments(img, min_length: float = 3.0,
                         opts: ManhattanOptions = None,
                         band_px: float = 2.0, gap_px: float = 4.0,
                         device=None):
    """Line segments with end points (COLMAP's DetectLineSegments, LSD
    there): the Hough lines of `detect_lines` (on `device`), each line's
    strong pixels within its theta bin and band_px of it projected onto
    its direction, contiguous runs (split at gaps > gap_px) of at least
    min_length kept. Returns (segments (S, 2, 2) [start, end] in pixel
    coordinates, line_idx (S,) into the lines)."""
    opts = opts or ManhattanOptions()
    lines, support, thetas = detect_lines(img, opts, device=device)
    if len(lines) == 0:
        return np.zeros((0, 2, 2)), np.zeros(0, int)

    im = (img.cpu().numpy() if isinstance(img, torch.Tensor)
          else np.asarray(img)).astype(np.float32)
    gx = np.zeros_like(im)
    gy = np.zeros_like(im)
    gx[:, 1:-1] = im[:, 2:] - im[:, :-2]
    gy[1:-1, :] = im[2:, :] - im[:-2, :]
    mag = np.hypot(gx, gy)
    ang = np.mod(np.arctan2(gy, gx), np.pi)
    strong = mag > np.percentile(mag, 90.0)
    ys, xs = np.nonzero(strong)
    pix_ang = ang[ys, xs]

    segments_, seg_line = [], []
    dth = np.pi / opts.num_theta_bins
    for k, (ln, th) in enumerate(zip(lines, thetas)):
        # orientation gate (wraps at pi) and distance-to-line gate
        dang = np.abs(np.mod(pix_ang - th + np.pi / 2, np.pi) - np.pi / 2)
        near = dang < dth
        d = np.abs(ln[0] * xs[near] + ln[1] * ys[near] + ln[2])
        sel = d < band_px
        if sel.sum() < min_length:
            continue
        xn, yn = xs[near][sel], ys[near][sel]
        # parameter along the line direction (-sin, cos)
        t = -np.sin(th) * xn + np.cos(th) * yn
        ts = t[np.argsort(t)]
        cut = np.nonzero(np.diff(ts) > gap_px)[0]
        starts = np.concatenate([[0], cut + 1])
        ends = np.concatenate([cut, [len(ts) - 1]])
        # foot of the line: its point closest to the origin
        x0, y0 = -ln[2] * ln[0], -ln[2] * ln[1]
        dvec = np.array([-np.sin(th), np.cos(th)])
        for s, e in zip(starts, ends):
            if ts[e] - ts[s] >= min_length:
                p0 = np.array([x0, y0]) + ts[s] * dvec
                p1 = np.array([x0, y0]) + ts[e] * dvec
                segments_.append(np.stack([p0, p1]))
                seg_line.append(k)
    if not segments_:
        return np.zeros((0, 2, 2)), np.zeros(0, int)
    return np.stack(segments_), np.asarray(seg_line)


HORIZONTAL, VERTICAL, UNDEFINED = 1, -1, 0


def classify_line_segment_orientations(segments: np.ndarray,
                                       tolerance: float = 0.25):
    """HORIZONTAL / VERTICAL / UNDEFINED per segment: a unit direction
    component below `tolerance` (COLMAP's
    ClassifyLineSegmentOrientations)."""
    if len(segments) == 0:
        return np.zeros(0, int)
    d = segments[:, 1] - segments[:, 0]
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    out = np.full(len(segments), UNDEFINED, int)
    out[np.abs(d[:, 1]) < tolerance] = HORIZONTAL
    out[np.abs(d[:, 0]) < tolerance] = VERTICAL
    return out
