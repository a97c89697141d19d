"""The port's warps and undistortion against the JAX package on the CPU.

scene/warp.py (bilinear sampling, homography warps, warps between camera
models, the antialiased bilinear resize both up and down) and
scene/undistortion.py (the undistorted camera, image and keypoint
undistortion, stereo rectification) for every camera model family, in
float64 on both sides, to rel 1e-9. An output pixel whose source
coordinate lies within 1e-9 px of the image's in-bounds limits is decided
by rounding (the sample there is either the image's edge value or 0 in
either package); such pixels are counted and left out, and there must
be few.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.scene import undistortion as j_und
from dagsfm_tpu.scene import warp as j_warp
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.scene import undistortion as t_und
from dagsfm_tpu_torch.scene import warp as t_warp

torch.set_num_threads(1)

H, W = 36, 48
# one camera of each model family, all (W, H), COLMAP parameter order
MODELS = {
    "SIMPLE_PINHOLE": (40.0, 24.0, 18.0),
    "PINHOLE": (40.0, 41.5, 23.7, 18.2),
    "SIMPLE_RADIAL": (40.0, 24.3, 17.9, -0.12),
    "RADIAL": (40.0, 24.3, 17.9, -0.1, 0.02),
    "OPENCV": (40.0, 41.0, 24.2, 18.1, -0.08, 0.01, 0.002, -0.001),
    "OPENCV_FISHEYE": (40.0, 41.0, 24.2, 18.1, 0.05, -0.01, 0.002, 0.0),
    "FOV": (40.0, 41.0, 24.2, 18.1, 0.9),
}


def camera(name, cid=1, params=None):
    return j_cm.Camera(cid, j_cm.CAMERA_MODEL_IDS[name], W, H,
                       MODELS[name] if params is None else params)


def image(seed=0, shape=(H, W)):
    return np.random.default_rng(seed).uniform(0, 1, shape)


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def on_edge(sx, sy, h=H, w=W, eps=1e-9):
    """Pixels whose source coordinate is within eps of an in-bounds limit."""
    return ((np.abs(sx) < eps) | (np.abs(sx - (w - 1)) < eps)
            | (np.abs(sy) < eps) | (np.abs(sy - (h - 1)) < eps))


def hold(got, ref, edge, max_edge=None):
    """got == ref to rel 1e-9 off the flagged edge pixels, which must be at
    most max_edge (default: one image border's worth)."""
    edge = np.broadcast_to(edge.reshape(edge.shape + (1,) * (
        np.ndim(ref) - edge.ndim)), np.shape(ref))
    assert rel_err(np.where(edge, 0, got), np.where(edge, 0, ref)) <= 1e-9
    assert int(edge.sum()) <= (max_edge if max_edge is not None
                               else 2 * (H + W) * max(1, np.ndim(ref) - 1))


def test_bilinear_gray_and_color():
    rng = np.random.default_rng(1)
    y = rng.uniform(-2, H + 1, (20, 30))
    x = rng.uniform(-2, W + 1, (20, 30))
    y[0, :4] = [0, H - 1, 5, 7]
    x[0, :4] = [3, 6, 0, W - 1]                   # on the limits exactly
    for img in (image(2), image(3, (H, W, 3))):
        ref = j_warp._bilinear(jnp.asarray(img), jnp.asarray(y),
                               jnp.asarray(x))
        got = t_warp._bilinear(torch.as_tensor(img), torch.as_tensor(y),
                               torch.as_tensor(x))
        assert rel_err(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("out_shape", [None, (30, 40)])
def test_warp_image_with_homography(color, out_shape):
    img = image(4, (H, W, 3) if color else (H, W))
    Hm = np.array([[1.02, 0.03, -1.5], [-0.02, 0.98, 2.2], [1e-4, -2e-4, 1.0]])
    ref = j_warp.warp_image_with_homography(jnp.asarray(img), jnp.asarray(Hm),
                                            out_shape)
    got = t_warp.warp_image_with_homography(torch.as_tensor(img), Hm,
                                            out_shape)
    assert rel_err(got.numpy(), ref) <= 1e-9


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("to_pinhole", [True, False])
def test_warp_between_cameras(name, to_pinhole):
    """Each model to a pinhole view and a pinhole view to it."""
    pin = camera("PINHOLE", 2, (42.0, 42.0, 24.0, 18.0))
    src, dst = (camera(name), pin) if to_pinhole else (pin, camera(name))
    img = image(5)
    ref = np.asarray(j_warp.warp_image_between_cameras(src, dst,
                                                       jnp.asarray(img)))
    got = t_warp.warp_image_between_cameras(
        interop.camera(src), interop.camera(dst), torch.as_tensor(img))
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    uv = t_cm.cam_from_img(dst.model_id, t_cm.pad_params(dst.params,
                                                         dst.model_id),
                           torch.as_tensor(np.stack([xs, ys], -1)))
    sp = t_cm.img_from_cam(src.model_id, t_cm.pad_params(src.params,
                                                         src.model_id),
                           torch.cat([uv, torch.ones_like(uv[..., :1])], -1))
    hold(got.numpy(), ref, on_edge(sp[..., 0].numpy(), sp[..., 1].numpy()))


@pytest.mark.parametrize("shape", [(60, 80), (12, 17), (50, 20), (36, 48)])
@pytest.mark.parametrize("color", [False, True])
def test_resample_bilinear_up_and_down(shape, color):
    """jax.image.resize antialiases on the way down; the port's weights
    are the same on both sides of a scale of 1."""
    img = image(6, (H, W, 3) if color else (H, W))
    ref = j_warp.resample_image_bilinear(jnp.asarray(img), *shape)
    got = t_warp.resample_image_bilinear(torch.as_tensor(img), *shape)
    assert rel_err(got.numpy(), ref) <= 1e-9


def test_resample_down_is_not_plain_interpolate():
    """Shrinking by 3 averages over the widened kernel: plain bilinear
    interpolation samples only two rows, and differs."""
    img = image(7)
    got = t_warp.resample_image_bilinear(torch.as_tensor(img), 12, 16)
    plain = torch.nn.functional.interpolate(
        torch.as_tensor(img)[None, None], size=(12, 16), mode="bilinear",
        align_corners=False)[0, 0]
    assert float((got - plain).abs().max()) > 1e-2
    assert abs(float(got.mean()) - img.mean()) < 0.01


@pytest.mark.parametrize("name", sorted(MODELS))
def test_undistorted_camera(name):
    ref = j_und.undistorted_camera(camera(name))
    got = t_und.undistorted_camera(interop.camera(camera(name)))
    assert (got.model_id, got.width, got.height) == (
        ref.model_id, ref.width, ref.height) == (t_cm.PINHOLE, W, H)
    assert np.array_equal(np.asarray(got.params, float),
                          np.asarray(ref.params, float))


def _undistort_coords(cam):
    """Source pixel of every undistorted pixel (the reference's map)."""
    Kn = np.asarray(j_und.undistorted_camera(cam).calibration_matrix())
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    uv = np.stack([(xs - Kn[0, 2]) / Kn[0, 0], (ys - Kn[1, 2]) / Kn[1, 1]], -1)
    p = t_cm.pad_params(cam.params, cam.model_id)
    duv = t_cm.distort(cam.model_id, p, torch.as_tensor(uv))
    f = t_cm.focal_and_pp(cam.model_id, p)
    pix = (duv * f[:2] + f[2:]).numpy()
    return pix[..., 0], pix[..., 1]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_undistort_image(name):
    cam = camera(name)
    img = image(8).astype(np.float32)
    ref = j_und.undistort_image(img, cam)
    got = t_und.undistort_image(img, interop.camera(cam), device="cpu")
    assert got.dtype == ref.dtype == np.float64
    hold(got, ref, on_edge(*_undistort_coords(cam)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_undistort_reconstruction(name):
    spec = j_syn.SyntheticSceneSpec(num_cameras=4, num_points=60, seed=2,
                                    image_width=W, image_height=H,
                                    focal=40.0)
    rec = j_syn.to_reconstruction(j_syn.generate(spec))
    rec.cameras = {1: camera(name)}
    ref = j_und.undistort_reconstruction(rec)
    got = t_und.undistort_reconstruction(
        interop.reconstruction(rec.cameras, rec.images, rec.points3D),
        device="cpu")
    assert got.cameras[1] == interop.camera(ref.cameras[1])
    for i, im in ref.images.items():
        assert rel_err(got.images[i].xys, im.xys) <= 1e-9
        assert np.array_equal(got.images[i].point3D_ids, im.point3D_ids)


def _stereo_pose():
    from dagsfm_tpu.ops import rotations as j_rops
    R12 = np.asarray(j_rops.angleaxis_to_rotmat(
        jnp.asarray([0.03, -0.02, 0.04])))
    return np.asarray(j_rops.rotmat_to_quat_np(R12)), \
        np.array([1.0, 0.1, -0.05])


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_rectify_stereo_cameras(sign):
    q, t = _stereo_pose()
    c1 = camera("PINHOLE")
    c2 = camera("SIMPLE_PINHOLE")
    ref = j_und.rectify_stereo_cameras(c1, c2, q, sign * t)
    got = t_und.rectify_stereo_cameras(interop.camera(c1), interop.camera(c2),
                                       q, sign * t)
    for g, r in zip(got, ref):
        assert rel_err(g, r) <= 1e-12


def test_rectify_needs_pinhole_cameras():
    q, t = _stereo_pose()
    with pytest.raises(ValueError):
        t_und.rectify_stereo_cameras(interop.camera(camera("SIMPLE_RADIAL")),
                                     interop.camera(camera("PINHOLE")), q, t)


@pytest.mark.parametrize("out_shape", [None, (30, 40)])
def test_inverse_homography_warp(out_shape):
    img = image(9).astype(np.float32)
    Hm = np.array([[0.99, 0.02, 1.5], [-0.01, 1.01, -0.7], [1e-4, 0, 1.0]])
    ref = j_und.warp_image_with_homography(img, Hm, out_shape)
    got = t_und.warp_image_with_homography(img, Hm, out_shape, device="cpu")
    assert rel_err(got, ref) <= 1e-9


def test_rectify_and_undistort_stereo_pair():
    q, t = _stereo_pose()
    c1 = camera("SIMPLE_RADIAL")
    c2 = camera("OPENCV", 2)
    img1, img2 = image(10), image(11)
    ref = j_und.rectify_and_undistort_stereo_pair(img1, img2, c1, c2, q, t)
    got = t_und.rectify_and_undistort_stereo_pair(
        img1, img2, interop.camera(c1), interop.camera(c2), q, t,
        device="cpu")
    for g, r in zip(got, ref):
        assert rel_err(g, r) <= 1e-9


def test_undistort_options_carry_over():
    opts = j_und.UndistortOptions(blank_pixels=1.0, max_scale=3.0)
    import dataclasses
    got = interop.undistort_options(dataclasses.asdict(opts))
    assert dataclasses.asdict(got) == dataclasses.asdict(opts)


def test_entry_points_need_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cam = interop.camera(camera("SIMPLE_RADIAL"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_und.undistort_image(image(0), cam)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_und.warp_image_with_homography(image(0), np.eye(3))
