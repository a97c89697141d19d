"""Port SIFT, render_images and the pipeline's extraction vs the JAX
reference, on the same images.

Both packages must find the same valid keypoints in the same slots; the
positions agree to 1e-3 px and the descriptors to 1e-4 (the pyramids
agree to a few f32 ulps, which the sub-pixel refinement amplifies).

One difference is allowed and counted: the orientation histogram bins
each gradient sample by the floor of an f32 atan2, and XLA's and
PyTorch's atan2 differ in the last bit, so a sample at a bin edge can
fall into the neighbouring bin. The keypoint's orientation then moves by
up to a few hundredths of a radian and its descriptor with it. At most
1 % of the keypoints may show this (0.3-0.6 % do on these images); every
other keypoint holds the descriptor tolerance. The descriptor is the
square root of an L1-normalised histogram, and the root's slope grows
without bound near 0: so the histogram (the descriptor squared) is held
to 1e-5 in every element, and the descriptor itself to 1e-4 in every
element above 1e-2, where the root's slope is under 50."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.features import sift as j_sift
from dagsfm_tpu.pipeline import feature_pipeline as j_fp
from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.features import sift as t_sift
from dagsfm_tpu_torch.pipeline import feature_pipeline as t_fp
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.scene import synthetic as t_syn

torch.set_num_threads(1)

XY_TOL, DESC_TOL = 1e-3, 1e-4
AFFINE_XY, AFFINE_SHARE = 1e-4, 0.05


def blob_image(H, W, num_blobs=30, seed=0):
    """Random Gaussian blobs (tests/test_features.py's pattern)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W), np.float32)
    ys = rng.uniform(20, H - 20, num_blobs)
    xs = rng.uniform(20, W - 20, num_blobs)
    sig = rng.uniform(2.0, 6.0, num_blobs)
    amp = rng.uniform(0.4, 1.0, num_blobs) * rng.choice([-1, 1], num_blobs)
    yy, xx = np.mgrid[0:H, 0:W]
    for y, x, s, a in zip(ys, xs, sig, amp):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def _scene(W, H, n_cam=3):
    kw = dict(num_cameras=n_cam, num_points=50, image_width=W,
              image_height=H, focal=480.0 * W / 448, seed=4, ring_radius=9.0,
              point_cloud_extent=3.5, ring_height_jitter=0.3)
    return j_syn.generate(j_syn.SyntheticSceneSpec(**kw)), \
        t_syn.generate(t_syn.SyntheticSceneSpec(**kw))


def _same_orientation(ori_port, ori_ref, m):
    """Keypoints of mask m whose orientations agree to 1e-6 rad; the
    others (an atan2 bin-edge flip, see above) must be under 1 % and
    within 0.05 rad."""
    d = np.abs(np.angle(np.exp(1j * (ori_port - ori_ref))))
    same = m & (d < 1e-6)
    flipped = m & ~same
    assert flipped.sum() <= 0.01 * m.sum(), flipped.sum()
    assert (d[flipped] < 0.05).all(), d[flipped]
    return same


def _desc_close(port, ref):
    big = (np.abs(port) > 1e-2) & (np.abs(ref) > 1e-2)
    np.testing.assert_allclose(port[big], ref[big], rtol=0, atol=DESC_TOL)
    np.testing.assert_allclose(port ** 2, ref ** 2, rtol=0, atol=1e-5)


def _compare(jf, tf, affine=False):
    """With `affine`, a keypoint whose position differs by more than
    AFFINE_XY (the refinement's amplified f32 gap) is counted, at most
    AFFINE_SHARE of them, and its descriptor not compared: its affine
    shape may stretch the sampling grid up to 178x along one axis (the
    small eigenvalue at its 1e-9 floor), which multiplies that gap."""
    jf = [np.asarray(a) for a in jf]
    tf = [a.numpy() for a in tf]
    np.testing.assert_array_equal(tf[5], jf[5])               # mask
    m = jf[5]
    assert m.sum() > 20
    np.testing.assert_allclose(tf[0][m], jf[0][m], rtol=0, atol=XY_TOL)
    same = _same_orientation(tf[2], jf[2], m)
    if affine:
        moved = m & (np.abs(tf[0] - jf[0]).max(-1) > AFFINE_XY)
        print(f"affine: {int(moved.sum())} of {int(m.sum())} keypoints "
              f"moved by more than {AFFINE_XY} px")
        assert moved.sum() <= AFFINE_SHARE * m.sum()
        same &= ~moved
    _desc_close(tf[4][same], jf[4][same])
    np.testing.assert_allclose(tf[3][m], jf[3][m], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tf[1][m], jf[1][m], rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(tf[4][m], axis=-1), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("images", ["blobs", "render"])
def test_extract_matches_reference(images):
    if images == "blobs":
        imgs = np.stack([blob_image(128, 128, seed=s) for s in (0, 1)])
    else:
        _, tsc = _scene(160, 120, n_cam=1)
        imgs = t_syn.render_images(tsc, device="cpu")[1][None]
    jopts = j_sift.SiftOptions(max_num_features=512)
    topts = interop.sift_options(jopts._asdict())
    jf = j_sift.extract(jnp.asarray(imgs), jopts)
    tf = t_sift.extract(torch.as_tensor(imgs), topts)
    _compare(jf, tf)
    np.testing.assert_array_equal(
        t_sift.descriptors_to_uint8(tf.descriptor[0, :5]),
        j_sift.descriptors_to_uint8(jf.descriptor[0, :5]))


def test_upright_fixed_octaves_and_options():
    imgs = blob_image(128, 128, seed=2)[None]
    jopts = j_sift.SiftOptions(max_num_features=256, num_octaves=2,
                               first_octave=0, upright=True,
                               adaptive_candidates=False,
                               candidates_per_octave=256)
    _compare(j_sift.extract(jnp.asarray(imgs), jopts),
             t_sift.extract(torch.as_tensor(imgs),
                            interop.sift_options(jopts._asdict())))
    # the options that were not ported before run now, and are the
    # reference's (test_dsp_and_affine_shape_match_reference below)
    jopts = jopts._replace(domain_size_pooling=True, dsp_num_scales=3)
    _compare(j_sift.extract(jnp.asarray(imgs), jopts),
             t_sift.extract(torch.as_tensor(imgs),
                            interop.sift_options(jopts._asdict())))


@pytest.mark.parametrize("dsp,affine,images", [
    (True, False, "blobs"), (False, True, "blobs"), (True, True, "render")])
def test_dsp_and_affine_shape_match_reference(dsp, affine, images):
    """Domain-size pooling (the raw histograms averaged over
    dsp_num_scales domain sizes, then normalised) and the one-shot affine
    shape, alone and together, on test_extract_matches_reference's
    images."""
    if images == "blobs":
        imgs = np.stack([blob_image(128, 128, seed=s) for s in (0, 1)])
    else:
        _, tsc = _scene(160, 120, n_cam=1)
        imgs = t_syn.render_images(tsc, device="cpu")[1][None]
    jopts = j_sift.SiftOptions(max_num_features=384,
                               domain_size_pooling=dsp,
                               estimate_affine_shape=affine)
    jf = j_sift.extract(jnp.asarray(imgs), jopts)
    tf = t_sift.extract(torch.as_tensor(imgs),
                        interop.sift_options(jopts._asdict()))
    _compare(jf, tf, affine=affine)
    plain = t_sift.extract(torch.as_tensor(imgs),
                           t_sift.SiftOptions(max_num_features=384))
    m = tf.mask.numpy()
    gap = np.abs(tf.descriptor.numpy()[m] - plain.descriptor.numpy()[m])
    assert gap.max() > 0.05                  # the option changes them


def test_dsp_scales_are_jnp_linspace():
    """Within 4 ulps of the reference's jnp.linspace (numpy's and XLA's
    linspace round apart, as for the focal grid)."""
    for n, a, b in ((10, 1.0 / 6.0, 3.0), (4, 0.5, 2.0), (1, 0.3, 3.0),
                    (17, 0.1, 2.9)):
        opts = t_sift.SiftOptions(dsp_num_scales=n, dsp_min_scale=a,
                                  dsp_max_scale=b)
        np.testing.assert_array_max_ulp(t_sift._dsp_scales(opts),
                                        np.asarray(jnp.linspace(a, b, n)),
                                        maxulp=4)


@pytest.mark.parametrize("shape", [(64, 80), (240, 320), (50, 71)])
def test_resize_linear_matches_jax_image_resize(shape):
    """Up (first octave) and down (max_image_size, antialiased)."""
    img = np.stack([blob_image(120, 160, seed=s) for s in (3, 4)])
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (2,) + shape,
                                      "linear"))
    port = t_sift.resize_linear(torch.as_tensor(img), *shape).numpy()
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


def test_render_images_matches_reference():
    jsc, tsc = _scene(64, 48, n_cam=3)
    ref = j_syn.render_images(jsc, seed=2)
    port = t_syn.render_images(tsc, seed=2, device="cpu")
    assert ref.keys() == port.keys()
    for i in ref:
        assert port[i].dtype == np.float32 and port[i].shape == (48, 64)
        np.testing.assert_allclose(port[i], ref[i], rtol=0, atol=1e-5)


@pytest.mark.parametrize("k1", [0.0, -0.3])
def test_render_images_through_a_camera_matches_reference(k1):
    """camera=: each pixel's ray is the camera's undistortion of it (one
    cam_from_img over the pixel grid); at k1 = 0 that is the pinhole
    image."""
    jsc, tsc = _scene(96, 96, n_cam=2)
    params = (tsc.camera.params[0], 48.0, 48.0, k1)
    ref = j_syn.render_images(jsc, seed=1, camera=j_cm.Camera(
        1, j_cm.SIMPLE_RADIAL, 96, 96, params))
    port = t_syn.render_images(tsc, seed=1, device="cpu", camera=t_cm.Camera(
        1, t_cm.SIMPLE_RADIAL, 96, 96, params))
    plain = t_syn.render_images(tsc, seed=1, device="cpu")
    for i in ref:
        assert port[i].dtype == np.float32 and port[i].shape == (96, 96)
        np.testing.assert_allclose(port[i], ref[i], rtol=0, atol=1e-5)
    gap = np.abs(port[1] - plain[1]).max()
    assert gap < 1e-5 if k1 == 0.0 else gap > 0.05


def test_extract_features_with_resize_maps_keypoints_back():
    """FeaturePipeline.extract_features with a small max_image_size: the
    images are shrunk as the reference shrinks them and the keypoints
    scaled back to the input frame."""
    jsc, tsc = _scene(160, 120, n_cam=2)
    images = t_syn.render_images(tsc, device="cpu")
    jopts = j_fp.FeaturePipelineOptions(batch_size=2)
    jopts.sift = j_sift.SiftOptions(max_num_features=256, max_image_size=128)
    topts = t_fp.FeaturePipelineOptions(
        batch_size=2, sift=interop.sift_options(jopts.sift._asdict()))
    jcams = {i: j_cm.make_simple_camera(i, 160, 120, focal=171.4)
             for i in images}
    tcams = {i: t_cm.make_simple_camera(i, 160, 120, focal=171.4)
             for i in images}
    jfp = j_fp.FeaturePipeline(images, jcams, jopts)
    jfp.extract_features()
    tfp = t_fp.FeaturePipeline(images, tcams, topts, device="cpu")
    tfp.extract_features()
    assert tfp.bank is not None and tfp.bank.desc.dtype == torch.bfloat16
    for i in images:
        np.testing.assert_array_equal(tfp.masks[i], jfp.masks[i])
        m = jfp.masks[i]
        assert m.sum() > 20
        np.testing.assert_allclose(tfp.keypoints[i][m], jfp.keypoints[i][m],
                                   rtol=0, atol=XY_TOL * 160 / 128)
        np.testing.assert_allclose(tfp.kp_geom[i][m][:, 2],
                                   jfp.kp_geom[i][m][:, 2], rtol=1e-3)
        same = _same_orientation(tfp.kp_geom[i][:, 3], jfp.kp_geom[i][:, 3],
                                 m)
        _desc_close(tfp.descriptors[i][same], jfp.descriptors[i][same])
        assert tfp.keypoints[i][m].max() > 128          # mapped back
    assert "extraction" in tfp.timings


def test_interop_sift_features_round_trip():
    fields = {"xy": np.zeros((1, 3, 2)), "scale": np.ones((1, 3)),
              "orientation": np.zeros((1, 3)),
              "score": np.ones((1, 3), np.float32),
              "descriptor": np.ones((1, 3, 128)) / np.sqrt(128),
              "mask": np.array([[True, False, True]])}
    f = interop.sift_features(fields, device="cpu")
    assert f.mask.dtype == torch.bool and f.score.dtype == torch.float32
    assert f.xy.dtype == torch.float64
    assert dataclasses.is_dataclass(t_fp.FeaturePipelineOptions())
