"""The pixel path in both packages on the CPU: rendered images -> SIFT ->
exhaustive matching -> full E/F/H verification -> guided matching ->
mapper inputs (and, in the slow twins of tests/test_e2e_pixels.py and
tests/test_e2e_distorted.py, -> incremental mapping, the latter from
images seen through a distorted camera).

The two packages differ in two known places, so matches are compared as
counts, not bits: the port matches with bf16 descriptors (its K1 kernel's
contract) where the reference's CPU path matches in f32, and RANSAC draws
its samples from a torch.Generator instead of jax.random."""
import numpy as np
import pytest
import torch

from dagsfm_tpu.features import sift as j_sift
from dagsfm_tpu.pipeline import feature_pipeline as j_fp
from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.features import matching as t_fm
from dagsfm_tpu_torch.ops import two_view_classify as t_tvc
from dagsfm_tpu_torch.ops import matcher_kernel as mk
from dagsfm_tpu_torch.pipeline import feature_pipeline as t_fp
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm import incremental_mapper as t_im

torch.set_num_threads(1)


def _spec(W, H, n_cam):
    # tests/test_e2e_pixels.py's scene; the focal keeps its field of view
    return t_syn.SyntheticSceneSpec(
        num_cameras=n_cam, num_points=50, image_width=W, image_height=H,
        focal=480.0 * W / 448, seed=4, ring_radius=9.0,
        point_cloud_extent=3.5, ring_height_jitter=0.3)


def _pipelines(images, spec, sift_kw, **opt_kw):
    f = spec.focal
    jopts = j_fp.FeaturePipelineOptions(guided_matching=True, **opt_kw)
    jopts.sift = j_sift.SiftOptions(**sift_kw)
    topts = t_fp.FeaturePipelineOptions(
        guided_matching=True, sift=interop.sift_options(jopts.sift._asdict()),
        **opt_kw)
    W, H = spec.image_width, spec.image_height
    jfp = j_fp.FeaturePipeline(images, {i: j_cm.make_simple_camera(
        i, W, H, focal=f) for i in images}, jopts)
    tfp = t_fp.FeaturePipeline(images, {i: t_cm.make_simple_camera(
        i, W, H, focal=f) for i in images}, topts, device="cpu")
    return jfp, tfp


def test_pixel_stages_against_reference():
    spec = _spec(160, 120, 12)
    sc = t_syn.generate(spec)
    all_images = t_syn.render_images(sc, device="cpu")
    images = {i: all_images[i] for i in (1, 2, 3)}      # ring neighbours
    jfp, tfp = _pipelines(images, spec, dict(max_num_features=512,
                                             candidates_per_octave=512),
                          batch_size=3)
    jfp.extract_features()
    tfp.extract_features()
    for i in images:
        np.testing.assert_array_equal(tfp.masks[i], jfp.masks[i])
        m = jfp.masks[i]
        np.testing.assert_allclose(tfp.keypoints[i][m], jfp.keypoints[i][m],
                                   rtol=0, atol=1e-3)
    jfp.match_and_verify()
    before = mk.launches
    tfp.match_and_verify()
    assert mk.launches == before              # the CPU runs the plain version
    assert {"extraction", "matching", "verification"} <= tfp.timings.keys()

    assert set(tfp.two_view) == set(jfp.two_view)
    assert len(jfp.two_view) >= 2
    for pk, jrec in jfp.two_view.items():
        trec = tfp.two_view[pk]
        assert trec.config == jrec.config, pk
        nj, nt = len(jfp.matches[pk]), len(tfp.matches[pk])
        assert abs(nt - nj) <= 0.05 * nj + 2, (pk, nt, nj)
        # guided matching under each package's own model (the models
        # differ with the RANSAC samples) ...
        assert abs(trec.num_inliers - jrec.num_inliers) \
            <= 0.15 * jrec.num_inliers, (pk, trec.num_inliers,
                                         jrec.num_inliers)
        # ... and the port's guided matching under the reference's model
        # finds the reference's guided matches
        use_h = jrec.config in (t_tvc.PLANAR, t_tvc.PANORAMIC,
                                t_tvc.PLANAR_OR_PANORAMIC)
        i, j = pk
        gm, _ = t_fm.guided_match_pair(
            *(torch.as_tensor(np.asarray(a)) for a in (
                tfp.descriptors[i], tfp.descriptors[j], tfp.keypoints[i],
                tfp.keypoints[j], tfp.masks[i], tfp.masks[j],
                jrec.H if use_h else jrec.F)), use_homography=use_h)
        gm = gm.numpy()
        port = {tuple(r) for r in gm[gm[:, 0] >= 0]}
        ref = {tuple(r) for r in jrec.inlier_matches.astype(np.int64)}
        assert len(port & ref) >= 0.95 * max(len(port), len(ref)), pk
    cams, imgs, graph = tfp.to_mapper_inputs()
    assert sorted(imgs) == [1, 2, 3]
    assert all(len(imgs[i].xys) == int(tfp.masks[i].sum()) for i in imgs)


@pytest.mark.slow
def test_pixels_to_model_accuracy():
    """Port twin of tests/test_e2e_pixels.py::test_pixels_to_model_accuracy
    with the same scene, options and limits."""
    spec = _spec(448, 336, 12)
    sc = t_syn.generate(spec)
    images = t_syn.render_images(sc, device="cpu")
    cams = {i: t_cm.make_simple_camera(i, spec.image_width,
                                       spec.image_height, focal=spec.focal)
            for i in images}
    from dagsfm_tpu_torch.features import sift as t_sift
    opts = t_fp.FeaturePipelineOptions(batch_size=4, guided_matching=True)
    opts.sift = t_sift.SiftOptions(max_num_features=1024,
                                   candidates_per_octave=512, num_octaves=3)
    fp = t_fp.FeaturePipeline(images, cams, opts, device="cpu")
    fp.extract_features()
    assert all(int(fp.masks[i].sum()) > 500 for i in images)
    fp.match_and_verify()
    assert len(fp.two_view) >= 12
    assert max(v.num_inliers for v in fp.two_view.values()) > 100
    cams2, imgs2, graph = fp.to_mapper_inputs()
    rec = t_im.IncrementalMapper(cams2, imgs2, graph,
                                 t_im.MapperOptions(seed=0),
                                 device="cpu").reconstruct()
    err = t_syn.pose_errors(rec, sc)
    assert err["num_reg"] == 12, err
    assert err["ate"] < 0.1, err
    assert err["rot_err_deg_mean"] < 1.0, err


@pytest.mark.slow
def test_distorted_pixels_to_model_recovers_k1():
    """Port twin of tests/test_e2e_distorted.py: images rendered through
    SIMPLE_RADIAL (k1 = -0.12) -> SIFT -> matching -> verification ->
    mapping with BA intrinsics refinement, from an EXIF-like prior focal
    with k1 = 0 (variant A: k1 recovered) and from a blind camera
    (variant B: the distortion's sign found), at the test's limits."""
    from dagsfm_tpu_torch.features import sift as t_sift
    k1_true = -0.12
    spec = _spec(448, 336, 12)
    sc = t_syn.generate(spec)
    W, H = spec.image_width, spec.image_height
    truth = t_cm.Camera(1, t_cm.SIMPLE_RADIAL, W, H,
                        (spec.focal, W / 2.0, H / 2.0, k1_true))
    images = t_syn.render_images(sc, camera=truth, device="cpu")
    opts = t_fp.FeaturePipelineOptions(batch_size=4, guided_matching=True)
    opts.sift = t_sift.SiftOptions(max_num_features=1024,
                                   candidates_per_octave=512, num_octaves=3)

    def run_with(start):
        fp = t_fp.FeaturePipeline(images, {i: start for i in images}, opts,
                                  device="cpu")
        fp.extract_features()
        assert all(int(fp.masks[i].sum()) > 400 for i in images)
        fp.match_and_verify()
        assert len(fp.two_view) >= 10
        rec = t_im.IncrementalMapper(*fp.to_mapper_inputs(),
                                     t_im.MapperOptions(seed=0),
                                     device="cpu").reconstruct()
        err = t_syn.pose_errors(rec, sc)
        assert err["num_reg"] >= 10, err
        assert err["ate"] < 0.15, err
        assert err["rot_err_deg_mean"] < 1.5, err
        assert rec.cameras[1].model_name == "SIMPLE_RADIAL"
        return rec.cameras[1]

    prior = truth._replace(params=truth.params[:3] + (0.0,))
    final = run_with(prior)
    assert final.focal() == pytest.approx(spec.focal)
    assert final.params[3] == pytest.approx(k1_true, rel=0.2), final
    blind = t_cm.make_simple_camera(1, W, H, model="SIMPLE_RADIAL")
    assert not blind.prior_focal
    assert run_with(blind).params[3] < 0.3 * k1_true
