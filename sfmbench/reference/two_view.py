"""Plain reference of two-view verification: the judge of a pair's answer,
and a calibrated estimator for the control.

`judge_parts` takes a pair's matched pixels, the two calibrations and
the answer the program gave (configuration, model, relative pose, inlier
flags) and returns the parts of its gap by name:

* how far the model is from its kind in float64: an essential matrix's
  singular values (s, s, 0), a fundamental matrix's rank 2, and the
  orthonormality and determinant 1 of the rotation recovered from
  either (a homography's rotation is held by truth_readings instead: a
  pure rotation is the degenerate case of the homography's
  decomposition, whose square roots leave its rotation orthonormal to
  about 1e-7 in float64);
* the share of matches whose inlier flag disagrees with the model's own
  residual against the threshold (Sampson distance in normalized
  coordinates at (max_error / f_mean)^2 for an essential matrix, in
  pixels at max_error^2 for a fundamental matrix, transfer error for a
  homography), leaving out residuals within a relative 1e-6 of the
  threshold, where rounding decides;
* 1 where the answer is not an answer: a configuration without its
  model or pose, a count that is not the number of flags set, fewer
  inliers than min_num_inliers, or a pair that the program left out.

`truth_readings` holds the answer against the scene's true relative
pose, which the program never sees: whether its configuration is of the
truth's class (a pair of distinct centres is CALIBRATED or UNCALIBRATED,
which the model selection decides by a count; a pure rotation is
PLANAR, PANORAMIC or PLANAR_OR_PANORAMIC), its rotation's angle from the
true one, its translation's angle from the true direction, and its
inlier count over the count of matches that the true model takes within
max_error_px.

`estimate_calibrated` is the reference put in the program's place: an
essential-matrix RANSAC (eight-point minimal samples, MSAC scoring,
refits on the inliers while the score falls, projection onto the
essential matrices) and the pose with the most points in front of both
cameras, in any dtype.
"""

from __future__ import annotations

import numpy as np
import torch

CALIBRATED, UNCALIBRATED = 2, 3
PLANAR, PANORAMIC, PLANAR_OR_PANORAMIC = 4, 5, 6
E_CLASS = (CALIBRATED, UNCALIBRATED)
H_CLASS = (PLANAR, PANORAMIC, PLANAR_OR_PANORAMIC)
BAND = 1e-6


def _sampson(F, x1, x2):
    p1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    p2 = np.concatenate([x2, np.ones((len(x2), 1))], 1)
    Fx1 = p1 @ F.T
    Ftx2 = p2 @ F
    num = np.sum(p2 * Fx1, 1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return num / np.maximum(den, 1e-300)


def _transfer(H, x1, x2):
    q = np.concatenate([x1, np.ones((len(x1), 1))], 1) @ H.T
    return np.sum((q[:, :2] / q[:, 2:] - x2) ** 2, 1)


def _rotation_gap(R):
    R = np.asarray(R, np.float64)
    return max(float(np.abs(R.T @ R - np.eye(3)).max()),
               abs(float(np.linalg.det(R)) - 1.0))


def _flag_gap(r, thr, flags):
    rel = r / thr - 1.0
    decided = np.abs(rel) > BAND
    wrong = (r < thr) != flags
    return float(np.mean(wrong & decided)) if len(r) else 0.0


def judge_parts(pix1, pix2, K1, K2, answer, max_error_px: float,
                min_num_inliers: int) -> dict:
    """The parts of one pair's gap by name (see the module): `answer` (1
    where the answer is no answer), `E_rank` and `E_equal` (an essential
    matrix's s3 / s1 and (s1 - s2) / s1), `F_rank`, `R` (the rotation's
    orthonormality and determinant) and `flags` (the share of flags that
    disagree with the model's own residual). answer: None (the pair was
    left out) or a dict with config, E, F, H, R, t, flags (bool per
    match) and num_inliers."""
    if answer is None:
        return dict(answer=1.0)
    flags = np.asarray(answer["flags"], bool)
    config = answer["config"]
    if len(flags) != len(pix1) or int(flags.sum()) != answer["num_inliers"] \
            or answer["num_inliers"] < min_num_inliers:
        return dict(answer=1.0)
    out = {}
    if config == CALIBRATED:
        if answer["E"] is None or answer["R"] is None:
            return dict(answer=1.0)
        E = np.asarray(answer["E"], np.float64)
        s = np.linalg.svd(E, compute_uv=False)
        out.update(E_rank=s[2] / s[0], E_equal=(s[0] - s[1]) / s[0])
        f_mean = (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
        out["flags"] = _flag_gap(
            _sampson(E, _normalized(pix1, K1), _normalized(pix2, K2)),
            (max_error_px / f_mean) ** 2, flags)
    elif config == UNCALIBRATED:
        if answer["F"] is None or answer["R"] is None:
            return dict(answer=1.0)
        F = np.asarray(answer["F"], np.float64)
        s = np.linalg.svd(F, compute_uv=False)
        out["F_rank"] = s[2] / s[0]
        out["flags"] = _flag_gap(_sampson(F, pix1, pix2), max_error_px ** 2,
                                 flags)
    elif config in H_CLASS:
        if answer["H"] is None:
            return dict(answer=1.0)
        out["flags"] = _flag_gap(
            _transfer(np.asarray(answer["H"], np.float64), pix1, pix2),
            max_error_px ** 2, flags)
    else:
        return dict(answer=1.0)
    if answer["R"] is not None and config in E_CLASS:
        out["R"] = _rotation_gap(answer["R"])
    return {k: float(v) for k, v in out.items()}


def relative_pose(Ra, ta, Rb, tb):
    """(R, t, rotation_only) of image b from image a, each x = R X + t:
    rotation_only where the two centres coincide."""
    R = Rb @ Ra.T
    t = tb - R @ ta
    scale = max(np.linalg.norm(ta), np.linalg.norm(tb), 1.0)
    return R, t, bool(np.linalg.norm(t) < 1e-9 * scale)


def _normalized(pix, K):
    return (pix - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])


def _skew(t):
    return np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]],
                     [-t[1], t[0], 0.0]])


def _angle_deg(c):
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def true_inliers(pix1, pix2, K1, K2, R, t, rotation_only: bool,
                 max_error_px: float) -> int:
    """Matches within max_error_px of the true model: the homography
    K2 R K1^-1 for a pure rotation (transfer error), else the essential
    matrix [t]x R (Sampson distance, in normalized coordinates at the
    program's threshold)."""
    if rotation_only:
        H = K2 @ R @ np.linalg.inv(K1)
        return int(np.sum(_transfer(H, pix1, pix2) < max_error_px ** 2))
    f_mean = (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
    r = _sampson(_skew(t / np.linalg.norm(t)) @ R, _normalized(pix1, K1),
                 _normalized(pix2, K2))
    return int(np.sum(r < (max_error_px / f_mean) ** 2))


def truth_readings(pix1, pix2, K1, K2, answer, R, t, rotation_only: bool,
                   max_error_px: float) -> dict:
    """The answer against the true relative pose (R, t): class_off (1
    where the configuration is not of the truth's class), rotation_deg,
    translation_deg (0 for a pure rotation) and inlier_share (the
    answer's count over true_inliers)."""
    n_true = true_inliers(pix1, pix2, K1, K2, R, t, rotation_only,
                          max_error_px)
    out = dict(class_off=0, rotation_deg=180.0, translation_deg=0.0,
               inlier_share=answer["num_inliers"] / max(n_true, 1))
    want = H_CLASS if rotation_only else E_CLASS
    out["class_off"] = int(answer["config"] not in want)
    if answer["R"] is None:
        return out
    Ra = np.asarray(answer["R"], np.float64)
    out["rotation_deg"] = _angle_deg((np.trace(Ra @ R.T) - 1.0) / 2.0)
    if not rotation_only:
        ta = np.asarray(answer["t"], np.float64)
        out["translation_deg"] = _angle_deg(
            ta @ t / max(np.linalg.norm(ta) * np.linalg.norm(t), 1e-300))
    return out


def _conditioner(x, w):
    """(..., 3, 3) similarity taking the weighted points x (..., N, 2) to
    zero mean and a mean distance of sqrt(2) (Hartley's)."""
    ws = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    mean = (x * w[..., None]).sum(-2) / ws
    d = torch.linalg.norm(x - mean[..., None, :], dim=-1)
    scale = 2.0 ** 0.5 / torch.clamp((d * w).sum(-1, keepdim=True) / ws,
                                     min=torch.finfo(x.dtype).tiny)
    T = torch.zeros(x.shape[:-2] + (3, 3), dtype=x.dtype, device=x.device)
    T[..., 0, 0] = T[..., 1, 1] = scale[..., 0]
    T[..., :2, 2] = -scale * mean
    T[..., 2, 2] = 1.0
    return T


def _eight_point(x1, x2, w):
    """Essential matrices (B, 3, 3) from weighted rows: x1, x2 (B, N, 2),
    w (B, N); the points conditioned first (Hartley), the result
    projected onto the essential matrices."""
    T1, T2 = _conditioner(x1, w), _conditioner(x2, w)
    a = torch.cat([x1, torch.ones_like(x1[..., :1])], -1) @ T1.transpose(-1, -2)
    b = torch.cat([x2, torch.ones_like(x2[..., :1])], -1) @ T2.transpose(-1, -2)
    A = (b[..., :, None] * a[..., None, :]).reshape(x1.shape[:-1] + (9,))
    A = A * w[..., None]
    _, _, Vt = torch.linalg.svd(A.transpose(-1, -2) @ A)
    E = T2.transpose(-1, -2) @ Vt[..., -1, :].reshape(x1.shape[:-2] + (3, 3)) @ T1
    U, S, Vt = torch.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    keep = torch.stack([s, s, torch.zeros_like(s)], -1)
    return (U * keep[..., None, :]) @ Vt


def _sampson_t(E, x1, x2):
    a = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    b = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    Ex1 = a @ E.transpose(-1, -2)
    Etx2 = b @ E
    num = torch.sum(b * Ex1, -1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 \
        + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=torch.finfo(E.dtype).tiny)


def _pose(E, x1, x2, flags):
    """(R, t) of E with the most inliers in front of both cameras."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)
    a = torch.cat([x1, torch.ones_like(x1[:, :1])], -1)[flags]
    b = torch.cat([x2, torch.ones_like(x2[:, :1])], -1)[flags]
    best, out = -1, None
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            # depths z1 a, z2 b with z2 b = z1 R a + t, least squares
            Ra = a @ R.T
            M = torch.stack([Ra, -b], -1)                    # (n, 3, 2)
            z = torch.linalg.lstsq(M, -t.expand(len(a), 3)[..., None]
                                   ).solution[..., 0]
            n = int(((z[:, 0] > 0) & (z[:, 1] > 0)).sum())
            if n > best:
                best, out = n, (R, t)
    return out


def estimate_calibrated(pix1, pix2, K1, K2, max_error_px: float,
                        num_hypotheses: int, seed: int, dtype, device,
                        refits: int = 10):
    """The control's answer for one pair, computed in `dtype`: a dict as
    `judge` takes it, with config CALIBRATED."""
    f64 = np.float64
    x1 = (pix1 - K1[:2, 2]) / np.array([K1[0, 0], K1[1, 1]], f64)
    x2 = (pix2 - K2[:2, 2]) / np.array([K2[0, 0], K2[1, 1]], f64)
    f_mean = (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
    thr = (max_error_px / f_mean) ** 2
    t1 = torch.as_tensor(x1, dtype=dtype, device=device)
    t2 = torch.as_tensor(x2, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = len(x1)
    keys = torch.rand((num_hypotheses, n), generator=g, device=device)
    idx = torch.topk(keys, 8, dim=1).indices
    E = _eight_point(t1[idx], t2[idx], torch.ones(idx.shape, dtype=dtype,
                                                  device=device))
    r = _sampson_t(E, t1[None], t2[None])
    thr_t = torch.tensor(thr, dtype=dtype, device=device)
    score = torch.minimum(r, thr_t).sum(-1)
    k = int(torch.argmin(score))
    E, best = E[k], score[k]
    flags = r[k] < thr_t
    for _ in range(refits):
        E_fit = _eight_point(t1[None], t2[None], flags[None].to(dtype))[0]
        r2 = _sampson_t(E_fit, t1, t2)
        s2 = torch.minimum(r2, thr_t).sum()
        if s2 >= best:
            break
        E, best, flags = E_fit, s2, r2 < thr_t
    R, t = _pose(E, t1, t2, flags)
    flags = flags.cpu().numpy()
    return dict(config=CALIBRATED, E=E.cpu().numpy(), F=None, H=None,
                R=R.cpu().numpy(), t=t.cpu().numpy(), flags=flags,
                num_inliers=int(flags.sum()))
