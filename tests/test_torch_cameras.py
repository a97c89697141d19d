"""Port camera models vs the JAX reference, every model, float64 numpy
inputs from a seed: distortion, projection, the Newton undistortion,
distortion Jacobians, the 8-slot intrinsics increment, padding, default
cameras and the focal scaling of the focal grid."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu_torch.scene import cameras as t_cm

torch.set_num_threads(1)
MODELS = list(j_cm.CAMERA_MODEL_NAMES.values())


def T(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _params(model: str, seed: int = 0) -> np.ndarray:
    """Padded params of a plausible camera of `model`: focal 500 (fy 520),
    principal point (320, 240), small distortion terms."""
    mid = j_cm.CAMERA_MODEL_IDS[model]
    rng = np.random.default_rng(seed + mid)
    base = ([500.0, 320.0, 240.0] if mid in j_cm._SINGLE_FOCAL
            else [500.0, 520.0, 320.0, 240.0])
    n = j_cm.CAMERA_MODEL_NUM_PARAMS[mid]
    p = np.zeros(12)
    p[:len(base)] = base
    p[len(base):n] = rng.normal(0.0, 0.05, n - len(base))
    if model == "FOV":
        p[4] = 0.9                                   # omega
    return p


def _uv(seed: int, n: int = 64) -> np.ndarray:
    uv = np.random.default_rng(seed).uniform(-0.5, 0.5, (n, 2))
    uv[0] = 0.0                                      # the r < 1e-8 branches
    return uv


@pytest.mark.parametrize("model", MODELS)
def test_distort(model):
    mid, p, uv = j_cm.CAMERA_MODEL_IDS[model], _params(model), _uv(1)
    np.testing.assert_allclose(
        t_cm.distort(mid, T(p), T(uv)).numpy(),
        np.asarray(j_cm.distort(mid, jnp.asarray(p), jnp.asarray(uv))),
        rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("model", MODELS)
def test_img_from_cam(model):
    mid, p = j_cm.CAMERA_MODEL_IDS[model], _params(model)
    rng = np.random.default_rng(2)
    xyz = np.concatenate([rng.normal(0, 0.8, (64, 2)),
                          rng.uniform(1, 5, (64, 1))], 1)
    xyz[1, 2] = 0.0                                  # the clamped depth
    np.testing.assert_allclose(
        t_cm.img_from_cam(mid, T(p), T(xyz)).numpy(),
        np.asarray(j_cm.img_from_cam(mid, jnp.asarray(p), jnp.asarray(xyz))),
        rtol=1e-12)


@pytest.mark.parametrize("model", MODELS)
def test_cam_from_img(model):
    mid, p = j_cm.CAMERA_MODEL_IDS[model], _params(model)
    xy = np.random.default_rng(3).uniform([40, 30], [600, 450], (48, 2))
    xy[0] = t_cm.focal_and_pp(mid, T(p)).numpy()[2:]  # the principal point
    port = t_cm.cam_from_img(mid, T(p), T(xy)).numpy()
    ref = np.asarray(j_cm.cam_from_img(mid, jnp.asarray(p), jnp.asarray(xy)))
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-10)
    # the undistortion inverts the projection
    xyz = np.concatenate([port, np.ones((len(port), 1))], 1)
    np.testing.assert_allclose(t_cm.img_from_cam(mid, T(p), T(xyz)).numpy(),
                               xy, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model", MODELS)
def test_distort_jacobians(model):
    """distort's 2x2 Jacobian and its extra-slot columns against
    jax.jacfwd of the reference's distort."""
    mid, p, uv = j_cm.CAMERA_MODEL_IDS[model], _params(model), _uv(4, 16)
    uv[0] = [0.3, -0.2]        # jacfwd through the clamped sqrt is 0 at 0
    d, Juv, Jx = t_cm.distort_jacobians(mid, T(p), T(uv), wrt_extra=True)
    ref_uv = jax.vmap(jax.jacfwd(
        lambda x: j_cm.distort(mid, jnp.asarray(p), x)))(jnp.asarray(uv))
    ref_p = np.asarray(jax.vmap(jax.jacfwd(
        lambda q, x: j_cm.distort(mid, q, x)), (None, 0))(
            jnp.asarray(p), jnp.asarray(uv)))
    first = 3 if mid in j_cm._SINGLE_FOCAL else 4
    n = j_cm.CAMERA_MODEL_NUM_PARAMS[mid]
    ref_x = np.zeros((len(uv), 2, 4))
    for k in range(4):
        if first + k < n:
            ref_x[:, :, k] = ref_p[:, :, first + k]
    np.testing.assert_allclose(Juv.numpy(), np.asarray(ref_uv), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(Jx.numpy(), ref_x, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        d.numpy(), np.asarray(j_cm.distort(mid, jnp.asarray(p),
                                           jnp.asarray(uv))), rtol=1e-12)


@pytest.mark.parametrize("model", MODELS)
def test_apply_intrinsics_delta(model):
    mid, p = j_cm.CAMERA_MODEL_IDS[model], _params(model)
    dint = np.random.default_rng(5).normal(0.0, 0.1, 8)
    np.testing.assert_allclose(
        t_cm.apply_intrinsics_delta(mid, T(p), T(dint)).numpy(),
        np.asarray(j_cm.apply_intrinsics_delta(mid, jnp.asarray(p),
                                               jnp.asarray(dint))),
        rtol=1e-12)


def test_mixed_models_in_one_batch():
    """Per-point model ids and params: each point gets what its model
    gives it alone (the reference's *_batched, vmap over lax.switch)."""
    rng = np.random.default_rng(6)
    mids = rng.integers(0, 11, 40)
    params = np.stack([_params(j_cm.CAMERA_MODEL_NAMES[m], 7) for m in mids])
    xyz = np.concatenate([rng.normal(0, 0.6, (40, 2)),
                          rng.uniform(1, 4, (40, 1))], 1)
    xy = rng.uniform([40, 30], [600, 450], (40, 2))
    dint = rng.normal(0.0, 0.1, (40, 8))
    m, pt = torch.as_tensor(mids), T(params)
    jm, jp = jnp.asarray(mids), jnp.asarray(params)
    np.testing.assert_allclose(
        t_cm.img_from_cam(m, pt, T(xyz)).numpy(),
        np.asarray(j_cm.img_from_cam_batched(jm, jp, jnp.asarray(xyz))),
        rtol=1e-12)
    np.testing.assert_allclose(
        t_cm.cam_from_img(m, pt, T(xy)).numpy(),
        np.asarray(j_cm.cam_from_img_batched(jm, jp, jnp.asarray(xy))),
        rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        t_cm.apply_intrinsics_delta(m, pt, T(dint)).numpy(),
        np.asarray(jax.vmap(j_cm.apply_intrinsics_delta)(
            jm, jp, jnp.asarray(dint))), rtol=1e-12)
    np.testing.assert_array_equal(
        t_cm.focal_and_pp(m, pt).numpy(),
        np.asarray(jax.vmap(j_cm.focal_and_pp)(jm, jp)))


def test_default_cameras_scale_focal_and_padding():
    for model in ("SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL"):
        for focal in (None, 700.0):
            jc = j_cm.make_simple_camera(3, 640, 480, focal=focal,
                                         model=model)
            tc = t_cm.make_simple_camera(3, 640, 480, focal=focal,
                                         model=model)
            assert tuple(tc) == tuple(jc)
            np.testing.assert_array_equal(tc.calibration_matrix(),
                                          jc.calibration_matrix())
            assert tuple(t_cm.scale_focal(tc, 0.7946)) == tuple(
                j_cm.scale_focal(jc, 0.7946))
            np.testing.assert_array_equal(
                t_cm.pad_params(tc.params, tc.model_id).numpy(),
                np.asarray(j_cm.pad_params(jc.params, jc.model_id)))
            np.testing.assert_array_equal(tc.padded_params(),
                                          np.asarray(j_cm.pad_params(
                                              jc.params, jc.model_id)))
    blind = t_cm.make_simple_camera(1, 1024, 768, model="SIMPLE_RADIAL")
    assert not blind.prior_focal and blind.params == (1228.8, 512.0, 384.0,
                                                      0.0)
    assert not t_cm.scale_focal(blind, 2.0).prior_focal
    opencv = t_cm.Camera(2, t_cm.OPENCV, 640, 480,
                         (500.0, 520.0, 320.0, 240.0, 0.1, 0, 0, 0))
    jopencv = j_cm.Camera(*opencv)
    assert tuple(t_cm.scale_focal(opencv, 1.5)) == tuple(
        j_cm.scale_focal(jopencv, 1.5))
    np.testing.assert_array_equal(opencv.calibration_matrix(),
                                  jopencv.calibration_matrix())
    with pytest.raises(ValueError):
        t_cm.make_simple_camera(1, 10, 10, model="OPENCV")
