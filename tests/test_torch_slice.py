"""The slice end to end in both packages on the CPU: planted features
(chip_smoke.plant_features) -> FeaturePipeline.match_and_verify ->
to_mapper_inputs -> IncrementalMapper.reconstruct -> write_model_bin.

RANSAC draws different samples in the two packages (jax.random vs a
torch.Generator), so the end results are compared, not the bits: the
same images registered, and both within the limits of
tests/test_incremental_mapper.py (ATE < 0.05, mean rotation error <
0.2 deg)."""
import numpy as np
import pytest
import torch

from chip_smoke import plant_features
from dagsfm_tpu.pipeline import feature_pipeline as j_fp
from dagsfm_tpu.scene import io as j_io
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import incremental_mapper as j_im
from dagsfm_tpu_torch.features import matching as t_fm
from dagsfm_tpu_torch.ops import matcher_kernel as mk
from dagsfm_tpu_torch.pipeline import feature_pipeline as t_fp
from dagsfm_tpu_torch.scene import io as t_io
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm import incremental_mapper as t_im

torch.set_num_threads(1)

N_IMG, K = 12, 256
ATE, ROT = 0.05, 0.2


def _spec(mod):
    return mod.SyntheticSceneSpec(num_cameras=N_IMG, num_points=300,
                                  pixel_noise=0.3, seed=2,
                                  max_track_length=6)


@pytest.fixture(scope="module")
def planted():
    sc = t_syn.generate(_spec(t_syn))
    return sc, plant_features(sc, K=K)


def _check(err):
    assert err["num_reg"] == N_IMG, err
    assert err["ate"] < ATE, err
    assert err["rot_err_deg_mean"] < ROT, err


def test_planted_features_follow_the_scene(planted):
    sc, (kps, descs, masks) = planted
    for i in range(N_IMG):
        vis = np.nonzero(sc.visible[i])[0]
        n = len(vis)
        np.testing.assert_array_equal(kps[i + 1][:n], sc.pixels[i, vis])
        np.testing.assert_allclose(np.linalg.norm(descs[i + 1][masks[i + 1]],
                                                  axis=1), 1.0, rtol=1e-5)
        assert (descs[i + 1] >= 0).all()
        assert masks[i + 1][:n].all() and not masks[i + 1][-1]


def test_slice_end_to_end_against_reference(planted, tmp_path):
    sc, (kps, descs, masks) = planted
    ids = sorted(kps)

    jsc = j_syn.generate(_spec(j_syn))
    jfp = j_fp.FeaturePipeline({i: None for i in ids},
                               {i: jsc.camera for i in ids},
                               j_fp.FeaturePipelineOptions(
                                   two_view_essential_only=True))
    jfp.keypoints, jfp.descriptors, jfp.masks = kps, descs, masks
    jfp.match_and_verify()
    jrec = j_im.IncrementalMapper(*jfp.to_mapper_inputs(),
                                  j_im.MapperOptions(seed=0)).reconstruct()

    tfp = t_fp.FeaturePipeline({i: None for i in ids},
                               {i: sc.camera for i in ids},
                               t_fp.FeaturePipelineOptions(
                                   two_view_essential_only=True),
                               device="cpu")
    tfp.keypoints, tfp.descriptors, tfp.masks = kps, descs, masks
    tfp.bank = t_fm.make_bank(descs, masks, ids, device="cpu")
    before = mk.launches
    tfp.match_and_verify()
    assert mk.launches == before          # the CPU runs the plain version
    assert {"pair_selection", "matching", "verification"} <= \
        tfp.timings.keys()
    trec = t_im.IncrementalMapper(*tfp.to_mapper_inputs(),
                                  t_im.MapperOptions(seed=0),
                                  device="cpu").reconstruct()

    # the bf16 matcher and the f32 one agree on nearly every pair
    assert set(tfp.two_view) == set(jfp.two_view)
    n_t = sum(len(m) for m in tfp.matches.values())
    n_j = sum(len(m) for m in jfp.matches.values())
    assert abs(n_t - n_j) <= 0.01 * n_j
    je, te = j_syn.pose_errors(jrec, jsc), t_syn.pose_errors(trec, sc)
    _check(je)
    _check(te)
    assert trec.num_points3D() == pytest.approx(jrec.num_points3D(), rel=0.1)

    t_io.write_model_bin(trec, str(tmp_path / "port"))
    back = j_io.read_model_bin(str(tmp_path / "port"))
    assert back.num_reg_images() == N_IMG
    assert back.num_points3D() == trec.num_points3D()


@pytest.mark.parametrize("mode", ["batch", "strict"])
def test_mapper_on_matching_problem(mode):
    """The mapper alone, from the synthetic matching problem (with match
    outliers), in both registration modes."""
    spec = dict(num_cameras=10, num_points=250, pixel_noise=0.3, seed=9)
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(**spec))
    cams, images, graph = t_syn.to_matching_problem(
        sc, match_outlier_fraction=0.1, seed=2)
    rec = t_im.IncrementalMapper(
        cams, images, graph,
        t_im.MapperOptions(init_min_num_inliers=30,
                           num_ransac_hypotheses=256, seed=3,
                           registration_mode=mode),
        device="cpu").reconstruct()
    err = t_syn.pose_errors(rec, sc)
    assert err["num_reg"] == 10, err
    assert err["ate"] < ATE and err["rot_err_deg_mean"] < ROT, err
    assert rec.compute_mean_reprojection_error() < 1.0

