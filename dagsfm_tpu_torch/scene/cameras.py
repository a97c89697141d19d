"""Camera models: project, distort and undistort for all eleven models.

Port of dagsfm_tpu/scene/cameras.py: the model id table (COLMAP
numbering, shared with the reference so files interoperate), `Camera`,
`make_simple_camera`, `scale_focal`, `pad_params`, the eleven
distortion functions, `img_from_cam` and `cam_from_img` (25 fixed
Newton steps of the reference's iterative undistortion), the 8-slot
intrinsics increment of bundle adjustment (`apply_intrinsics_delta`)
and `intrinsics_refine_mask`.

The reference dispatches per point with `lax.switch` under `vmap`. Here
`model_id` is a Python int, a 0-d tensor or a tensor broadcast against
the points: each model present is evaluated over the whole batch and the
results are selected with `torch.where`, so a batch of one model runs
one branch. Jacobians of `distort` come from forward-mode AD
(`torch.func.jvp`), as the reference's `jax.jacfwd`; every function is
elementwise per point, so a batch gives each point the bits it gets
alone.
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
NUM_MODELS = 11
NUM_INTRINSIC_SLOTS = 8
NUM_EXTRA_SLOTS = 4       # slots 4-7: the first four distortion params


def models_of(model_id) -> tuple:
    """The distinct model ids in `model_id` (an int or a tensor; a tensor
    of more than one element costs one device sync)."""
    if isinstance(model_id, (int, np.integer)):
        return (int(model_id),)
    t = torch.as_tensor(model_id)
    if t.numel() == 1:
        return (int(t.reshape(())),)
    return tuple(int(m) for m in torch.unique(t).tolist())


def _select(model_id, models: tuple, fn):
    """fn(m) for each model m in `models`, merged per element by
    model_id; fn returns a tensor or a tuple of tensors whose leading
    dims are model_id's."""
    out = fn(models[0])
    if len(models) == 1:
        return out
    single = not isinstance(out, tuple)
    out = (out,) if single else out
    mid = torch.as_tensor(model_id, device=out[0].device)
    for m in models[1:]:
        v = fn(m)
        v = (v,) if single else v
        out = tuple(torch.where((mid == m).reshape(
            mid.shape + (1,) * (a.dim() - mid.dim())), b, a)
            for a, b in zip(out, v))
    return out[0] if single else out


def _is_single_focal(model_id, device=None):
    if isinstance(model_id, (int, np.integer)):
        return torch.tensor(int(model_id) in _SINGLE_FOCAL, device=device)
    mid = torch.as_tensor(model_id, device=device)
    return torch.isin(mid, torch.tensor(_SINGLE_FOCAL, device=mid.device))


def _num_params(model_id, device=None) -> torch.Tensor:
    table = torch.tensor([CAMERA_MODEL_NUM_PARAMS[m]
                          for m in range(NUM_MODELS)],
                         device=device)
    return table[torch.as_tensor(model_id, device=device).long()]


def pad_params(params, model_id: int) -> torch.Tensor:
    """A per-model parameter list padded to MAX_CAMERA_PARAMS (float64)."""
    p = torch.as_tensor(np.asarray(params, np.float64))
    n = CAMERA_MODEL_NUM_PARAMS[model_id]
    assert p.shape[-1] == n, (p.shape, model_id)
    return torch.nn.functional.pad(p, (0, MAX_CAMERA_PARAMS - n))


def focal_and_pp(model_id, params: torch.Tensor) -> torch.Tensor:
    """(..., 4) = (fx, fy, cx, cy) from padded params (..., 12)."""
    single = _is_single_focal(model_id, params.device)
    s = torch.stack([params[..., 0], params[..., 0], params[..., 1],
                     params[..., 2]], -1)
    return torch.where(single[..., None], s, params[..., :4])


# ---------------------------------------------------------------------------
# Intrinsics increment of bundle adjustment: a fixed 8-slot local
# parameterisation shared by every model (the reference's layout):
#   slot 0: log-focal scale (applied to f, or to both fx and fy)
#   slot 1: log-aspect (fy only; no effect on single-focal models)
#   slots 2-3: principal point deltas (pixels)
#   slots 4-7: the first four extra (distortion) parameter deltas
# ---------------------------------------------------------------------------

def apply_intrinsics_delta(model_id, params: torch.Tensor,
                           dint: torch.Tensor) -> torch.Tensor:
    """Padded params (..., 12) after an 8-slot increment dint (..., 8);
    model_id broadcasts against the leading dims."""
    dev = params.device
    single = _is_single_focal(model_id, dev)
    fscale = torch.exp(dint[..., 0])
    p0 = params[..., 0] * fscale
    p1 = torch.where(single, params[..., 1],
                     params[..., 1] * fscale * torch.exp(dint[..., 1]))
    p = torch.cat([p0[..., None], p1[..., None], params[..., 2:]], -1)
    pp0 = torch.where(single, 1, 2)[..., None]
    idx = torch.arange(MAX_CAMERA_PARAMS, device=dev)
    add = torch.zeros_like(p)
    add = torch.where(idx == pp0, dint[..., 2:3], add)
    add = torch.where(idx == pp0 + 1, dint[..., 3:4], add)
    for k in range(NUM_EXTRA_SLOTS):
        add = torch.where(idx == pp0 + 2 + k, dint[..., 4 + k:5 + k], add)
    add = torch.where(idx < _num_params(model_id, dev)[..., None], add, 0.0)
    return p + add


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


# ---------------------------------------------------------------------------
# Per-model distortion of normalized coords (u, v) -> (du, dv); p is the
# padded param vector (..., 12), broadcast against u and v.
# ---------------------------------------------------------------------------

def _dist_none(p, u, v):           # SIMPLE_PINHOLE, PINHOLE
    return u, v


def _dist_simple_radial(p, u, v):  # f cx cy k
    k = p[..., 3]
    r2 = u * u + v * v
    radial = 1.0 + k * r2
    return u * radial, v * radial


def _dist_radial(p, u, v):         # f cx cy k1 k2
    k1, k2 = p[..., 3], p[..., 4]
    r2 = u * u + v * v
    radial = 1.0 + r2 * (k1 + k2 * r2)
    return u * radial, v * radial


def _dist_opencv(p, u, v):         # fx fy cx cy k1 k2 p1 p2
    k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    r2 = u * u + v * v
    radial = 1.0 + r2 * (k1 + k2 * r2)
    uv = u * v
    du = u * radial + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u * u)
    dv = v * radial + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v * v)
    return du, dv


def _dist_full_opencv(p, u, v):    # fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6
    k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    k3, k4, k5, k6 = p[..., 8], p[..., 9], p[..., 10], p[..., 11]
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
    radial = num / den
    uv = u * v
    du = u * radial + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u * u)
    dv = v * radial + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v * v)
    return du, dv


def _fisheye_theta(u, v):
    r = torch.sqrt(torch.clamp(u * u + v * v, min=1e-24))
    return r, torch.arctan(r)


def _dist_opencv_fisheye(p, u, v):  # fx fy cx cy k1 k2 k3 k4
    k1, k2, k3, k4 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    r, th = _fisheye_theta(u, v)
    th2 = th * th
    thd = th * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    s = torch.where(r < 1e-8, 1.0, thd / r)
    return u * s, v * s


def _dist_fov(p, u, v):            # fx fy cx cy omega
    omega = p[..., 4]
    r = torch.sqrt(torch.clamp(u * u + v * v, min=1e-24))
    tan_half = torch.tan(omega / 2.0)
    num = torch.arctan(2.0 * r * tan_half)
    tiny = torch.abs(omega) < 1e-8
    omega_safe = torch.where(tiny, 1.0, omega)
    factor = torch.where(tiny, 1.0, torch.where(
        r < 1e-8, 2.0 * tan_half / omega_safe, num / (r * omega_safe)))
    return u * factor, v * factor


def _dist_simple_radial_fisheye(p, u, v):  # f cx cy k
    k = p[..., 3]
    r, th = _fisheye_theta(u, v)
    thd = th * (1.0 + k * (th * th))
    s = torch.where(r < 1e-8, 1.0, thd / r)
    return u * s, v * s


def _dist_radial_fisheye(p, u, v):  # f cx cy k1 k2
    k1, k2 = p[..., 3], p[..., 4]
    r, th = _fisheye_theta(u, v)
    th2 = th * th
    thd = th * (1.0 + th2 * (k1 + th2 * k2))
    s = torch.where(r < 1e-8, 1.0, thd / r)
    return u * s, v * s


def _dist_thin_prism_fisheye(p, u, v):
    # fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1
    k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    k3, k4, sx1, sy1 = p[..., 8], p[..., 9], p[..., 10], p[..., 11]
    r, th = _fisheye_theta(u, v)
    s = torch.where(r < 1e-8, 1.0, th / r)
    uu, vv = u * s, v * s
    r2 = uu * uu + vv * vv
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    uv = uu * vv
    du = uu * radial + 2.0 * p1 * uv + p2 * (r2 + 2.0 * uu * uu) + sx1 * r2
    dv = vv * radial + 2.0 * p2 * uv + p1 * (r2 + 2.0 * vv * vv) + sy1 * r2
    return du, dv


_DISTORT_FNS = (
    _dist_none,                  # SIMPLE_PINHOLE
    _dist_none,                  # PINHOLE
    _dist_simple_radial,         # SIMPLE_RADIAL
    _dist_radial,                # RADIAL
    _dist_opencv,                # OPENCV
    _dist_opencv_fisheye,        # OPENCV_FISHEYE
    _dist_full_opencv,           # FULL_OPENCV
    _dist_fov,                   # FOV
    _dist_simple_radial_fisheye, # SIMPLE_RADIAL_FISHEYE
    _dist_radial_fisheye,        # RADIAL_FISHEYE
    _dist_thin_prism_fisheye,    # THIN_PRISM_FISHEYE
)


def _extra_index(m: int, k: int):
    """Param index of extra slot k of model m, or None past its params."""
    idx = (3 if m in _SINGLE_FOCAL else 4) + k
    return idx if idx < CAMERA_MODEL_NUM_PARAMS[m] else None


def distort(model_id, params: torch.Tensor, uv: torch.Tensor,
            models: tuple | None = None) -> torch.Tensor:
    """Model distortion of normalized coords uv (..., 2)."""
    models = models or models_of(model_id)
    return _select(model_id, models, lambda m: torch.stack(
        _DISTORT_FNS[m](params, uv[..., 0], uv[..., 1]), -1))


def distort_jacobians(model_id, params: torch.Tensor, uv: torch.Tensor,
                      wrt_extra: bool = False, models: tuple | None = None):
    """(distorted uv (..., 2), d/d(u, v) (..., 2, 2) with [out, in],
    d/d(extra slots) (..., 2, 4) or None): forward-mode derivatives, as
    the reference's jacfwd. An extra slot past the model's params has a
    zero column."""
    models = models or models_of(model_id)

    def one(m):
        u, v = uv[..., 0], uv[..., 1]
        if m in PINHOLE_MODELS:
            one_, zero = torch.ones_like(u), torch.zeros_like(u)
            J = torch.stack([torch.stack([one_, zero], -1),
                             torch.stack([zero, one_], -1)], -2)
            out = (uv, J)
            if wrt_extra:
                out += (torch.zeros(uv.shape + (NUM_EXTRA_SLOTS,),
                                    dtype=uv.dtype, device=uv.device),)
            return out

        def f(uu, vv):
            return torch.stack(_DISTORT_FNS[m](params, uu, vv), -1)
        one_, zero = torch.ones_like(u), torch.zeros_like(u)
        d, ju = torch.func.jvp(f, (u, v), (one_, zero))
        _, jv = torch.func.jvp(f, (u, v), (zero, one_))
        out = (d, torch.stack([ju, jv], -1))
        if wrt_extra:
            def g(pp):
                return torch.stack(_DISTORT_FNS[m](pp, u, v), -1)
            cols = []
            pb = params.expand(u.shape + (MAX_CAMERA_PARAMS,)).contiguous()
            for k in range(NUM_EXTRA_SLOTS):
                idx = _extra_index(m, k)
                if idx is None:
                    cols.append(torch.zeros_like(d))
                    continue
                tan = torch.zeros_like(pb)
                tan[..., idx] = 1.0
                cols.append(torch.func.jvp(g, (pb,), (tan,))[1])
            out += (torch.stack(cols, -1),)
        return out

    return _select(model_id, models, one)


def img_from_cam(model_id, params: torch.Tensor, xyz: torch.Tensor,
                 models: tuple | None = None) -> torch.Tensor:
    """Camera-frame point(s) (..., 3) -> pixels (..., 2); z is clamped
    away from 0, callers mask by cheirality."""
    z = xyz[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    uv = xyz[..., :2] / zs[..., None]
    duv = distort(model_id, params, uv, models)
    f = focal_and_pp(model_id, params)
    return duv * f[..., :2] + f[..., 2:]


def cam_from_img(model_id, params: torch.Tensor, xy: torch.Tensor,
                 num_iters: int = 25) -> torch.Tensor:
    """Pixels (..., 2) -> normalized coords: the reference's fixed-count
    Newton undistortion, each step solving with the 2x2 Jacobian of
    `distort` (determinant floored at 1e-18). For the pinhole models the
    first step leaves the start point as it is, so they return it."""
    models = models_of(model_id)
    f = focal_and_pp(model_id, params)
    uv_dist = (xy - f[..., 2:]) / f[..., :2]
    if all(m in PINHOLE_MODELS for m in models):
        return uv_dist
    uv = uv_dist
    for _ in range(num_iters):
        d, J = distort_jacobians(model_id, params, uv, models=models)
        r = d - uv_dist
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        det = torch.where(torch.abs(det) < 1e-18, 1e-18, det)
        du = (J[..., 1, 1] * r[..., 0] - J[..., 0, 1] * r[..., 1]) / det
        dv = (-J[..., 1, 0] * r[..., 0] + J[..., 0, 0] * r[..., 1]) / det
        uv = uv - torch.stack([du, dv], -1)
    return uv


# per-row model ids (N,) and params (N, 12): distort, img_from_cam and
# cam_from_img take a model-id tensor per element already
distort_batched = distort
img_from_cam_batched = img_from_cam
cam_from_img_batched = cam_from_img


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

    def padded_params(self) -> np.ndarray:
        p = np.zeros(MAX_CAMERA_PARAMS)
        p[: len(self.params)] = self.params
        return p

    def calibration_matrix(self) -> np.ndarray:
        if self.model_id in _SINGLE_FOCAL:
            fx, fy, cx, cy = (self.params[0], self.params[0],
                              self.params[1], self.params[2])
        else:
            fx, fy, cx, cy = self.params[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def scale_focal(cam: Camera, factor: float) -> Camera:
    """The camera with its focal length(s) scaled by `factor` (the
    focal-grid pick). prior_focal stays as it is: a grid estimate is not
    a calibration, and BA goes on refining it."""
    p = list(cam.params)
    p[0] = p[0] * factor
    if cam.model_id not in _SINGLE_FOCAL:
        p[1] = p[1] * factor
    return cam._replace(params=tuple(p))


def make_simple_camera(camera_id: int, width: int, height: int,
                       focal: float | None = None,
                       model: str = "SIMPLE_PINHOLE") -> Camera:
    """Default camera; focal=None takes the 1.2 * max-dim heuristic and
    leaves prior_focal False. SIMPLE_RADIAL starts at k = 0."""
    prior_focal = focal is not None
    if focal is None:
        focal = 1.2 * max(width, height)
    base = [focal, width / 2.0, height / 2.0]
    if model == "SIMPLE_PINHOLE":
        params = tuple(base)
    elif model == "PINHOLE":
        params = (focal, focal, width / 2.0, height / 2.0)
    elif model == "SIMPLE_RADIAL":
        params = tuple(base + [0.0])
    else:
        raise ValueError(f"unsupported default model {model}")
    return Camera(camera_id, CAMERA_MODEL_IDS[model], width, height, params,
                  prior_focal=prior_focal)
