"""Port scene layer vs the JAX reference: synthetic scenes, the
correspondence graph, exhaustive pairs, state carried across by
interop.py, SceneArrays, and COLMAP .bin files (byte-identical)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.features import retrieval as j_rt
from dagsfm_tpu.ops import projection as j_proj
from dagsfm_tpu.scene import io as j_io
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import correspondence_graph as j_cg
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.features import retrieval as t_rt
from dagsfm_tpu_torch.ops import projection as t_proj
from dagsfm_tpu_torch.scene import io as t_io
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm import correspondence_graph as t_cg

torch.set_num_threads(1)


def _spec(mod, **kw):
    base = dict(num_cameras=8, num_points=160, pixel_noise=0.5, seed=7,
                max_track_length=5)
    base.update(kw)
    return mod.SyntheticSceneSpec(**base)


@pytest.mark.parametrize("kw", [{}, {"outlier_fraction": 0.1},
                                {"camera_model": "PINHOLE"}])
def test_synthetic_scene_is_the_same(kw):
    js, ts = j_syn.generate(_spec(j_syn, **kw)), t_syn.generate(
        _spec(t_syn, **kw))
    for f in ("R", "t", "points", "visible", "pixels", "is_outlier"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    assert tuple(ts.camera) == tuple(js.camera)
    np.testing.assert_array_equal(ts.centers(), js.centers())


def test_matching_problem_and_graph():
    js, ts = j_syn.generate(_spec(j_syn)), t_syn.generate(_spec(t_syn))
    jc, ji, jg = j_syn.to_matching_problem(js, match_outlier_fraction=0.1,
                                           seed=3)
    tc, ti, tg = t_syn.to_matching_problem(ts, match_outlier_fraction=0.1,
                                           seed=3)
    assert tuple(tc[1]) == tuple(jc[1])
    assert ti.keys() == ji.keys()
    for i in ji:
        np.testing.assert_array_equal(ti[i].xys, ji[i].xys)
    assert tg.image_pairs() == jg.image_pairs()
    for (i, j) in jg.image_pairs():
        np.testing.assert_array_equal(tg.matches_between(i, j),
                                      jg.matches_between(i, j))
        np.testing.assert_array_equal(tg.matches_between(j, i),
                                      jg.matches_between(j, i))
    for i in ji:
        assert (tg.num_correspondences_for_image(i)
                == jg.num_correspondences_for_image(i))
        others = set(list(ji)[:3])
        np.testing.assert_array_equal(
            np.asarray(tg.correspondences_of_image(i, others=others)),
            np.asarray(jg.correspondences_of_image(i, others=others)))
        np.testing.assert_array_equal(tg.correspondences_of(i, 0),
                                      jg.correspondences_of(i, 0))
        assert (tg.num_observations_for_image(i)
                == jg.num_observations_for_image(i))
        for depth in (1, 3):
            np.testing.assert_array_equal(
                tg.find_transitive_correspondences(i, 1, depth),
                jg.find_transitive_correspondences(i, 1, depth))
    for (i, j) in jg.image_pairs()[:5]:
        assert (tg.num_correspondences_between(j, i)
                == jg.num_correspondences_between(j, i) > 0)
    jt = j_cg.build_tracks(jg, min_length=2, max_length=50)
    tt = t_cg.build_tracks(tg, min_length=2, max_length=50)
    assert [sorted(t) for t in tt] == [sorted(t) for t in jt]


def test_exhaustive_pairs():
    ids = list(range(1, 124))
    assert t_rt.exhaustive_pairs(ids) == j_rt.exhaustive_pairs(ids)
    assert t_rt.exhaustive_pairs(ids) == \
        j_rt.exhaustive_pairs(ids, block_size=7)


def _reference_model():
    """A JAX-side Reconstruction with colours, errors and one image left
    unregistered (written files skip it)."""
    rec = j_syn.to_reconstruction(j_syn.generate(_spec(j_syn)))
    rng = np.random.default_rng(0)
    for pid, pt in rec.points3D.items():
        pt.color = rng.integers(0, 256, 3).astype(np.uint8)
        pt.error = float(rng.random())
    rec.images[3].registered = False
    return rec


def test_interop_reconstruction_and_arrays():
    jrec = _reference_model()
    trec = interop.reconstruction(jrec.cameras, jrec.images, jrec.points3D)
    assert trec.num_reg_images() == jrec.num_reg_images()
    assert trec.num_points3D() == jrec.num_points3D()
    assert trec.compute_mean_reprojection_error() == pytest.approx(
        jrec.compute_mean_reprojection_error(), rel=1e-12)
    ja, jids = jrec.to_arrays()
    ta, tids = trec.to_arrays(device="cpu")
    assert tids == jids
    for f in ja._fields:
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    # the same arrays carried across directly
    tb = interop.scene_arrays(ja._asdict(), device="cpu")
    for f in ja._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    je = j_proj.reproj_errors_obs(ja)[0]
    te = t_proj.reproj_errors_obs(tb)[0]
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-10,
                               atol=1e-12)


def test_write_model_bin_is_byte_identical(tmp_path):
    jrec = _reference_model()
    trec = interop.reconstruction(jrec.cameras, jrec.images, jrec.points3D)
    j_io.write_model_bin(jrec, str(tmp_path / "jax"))
    t_io.write_model_bin(trec, str(tmp_path / "port"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b, name
        assert len(a) > 0
    # each package reads the other's files back whole
    back = t_io.read_model_bin(str(tmp_path / "jax"))
    assert back.num_reg_images() == jrec.num_reg_images() == 7
    assert back.points3D.keys() == jrec.points3D.keys()
    for pid, pt in jrec.points3D.items():
        np.testing.assert_array_equal(back.points3D[pid].xyz, pt.xyz)
        np.testing.assert_array_equal(back.points3D[pid].color, pt.color)
        assert back.points3D[pid].track == [tuple(o) for o in pt.track]
    for i, im in back.images.items():
        np.testing.assert_array_equal(im.point3D_ids,
                                      jrec.images[i].point3D_ids)
    t_io.write_model_bin(back, str(tmp_path / "again"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "again" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    jback = j_io.read_model_bin(str(tmp_path / "port"))
    assert jback.num_points3D() == trec.num_points3D()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_simple_radial_model_file_is_byte_identical(tmp_path):
    """A blind SIMPLE_RADIAL camera after refinement (focal and k1 moved,
    no prior) writes the reference's bytes and reads back as itself."""
    from dagsfm_tpu.scene import cameras as j_cm
    jrec = _reference_model()
    jrec.cameras[1] = j_cm.Camera(1, j_cm.SIMPLE_RADIAL, 1024, 768,
                                  (1097.316, 512.0, 384.0, -0.1187),
                                  prior_focal=False)
    trec = interop.reconstruction(jrec.cameras, jrec.images, jrec.points3D)
    assert trec.cameras[1].model_name == "SIMPLE_RADIAL"
    assert not trec.cameras[1].prior_focal
    j_io.write_model_bin(jrec, str(tmp_path / "jax"))
    t_io.write_model_bin(trec, str(tmp_path / "port"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    back = t_io.read_model_bin(str(tmp_path / "port"))
    assert back.cameras[1].model_id == j_cm.SIMPLE_RADIAL
    assert back.cameras[1].params == jrec.cameras[1].params


def test_pose_errors_match_reference():
    js = j_syn.generate(_spec(j_syn))
    jrec = j_syn.to_reconstruction(js)
    rng = np.random.default_rng(1)
    for im in jrec.images.values():
        im.tvec = im.tvec + rng.normal(0, 0.01, 3)
    trec = interop.reconstruction(jrec.cameras, jrec.images, jrec.points3D)
    ts = t_syn.generate(_spec(t_syn))
    je, te = j_syn.pose_errors(jrec, js), t_syn.pose_errors(trec, ts)
    assert je.keys() == te.keys()
    for k in je:
        assert te[k] == pytest.approx(je[k], rel=1e-10, abs=1e-12), k
