"""Port pair modes (FeaturePipeline.select_pairs), the four database
commands of pair selection, the vocab-tree .npz and gps vs the JAX
reference.

Both pipelines get the same features (the JAX package's SIFT, carried
in as float32, as the port's pipeline keeps them) and the same k-means
draws (`replay_key` / `replay_chain` into `retrieval._draw_init`); the
CLI commands run on copies of one database, the RANSAC samples of
`run_matcher_on_database` replayed (`test_torch_database.
reference_samples`). Pair lists, database rows and printed lines must
be the reference's."""
import dataclasses
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.features import sift as j_sift
from dagsfm_tpu.features import visual_index as j_vi
from dagsfm_tpu.pipeline import cli as j_cli
from dagsfm_tpu.pipeline import feature_pipeline as j_fp
from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.utils import gps as j_gps
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.features import retrieval as t_rt
from dagsfm_tpu_torch.features import visual_index as t_vi
from dagsfm_tpu_torch.pipeline import cli as t_cli
from dagsfm_tpu_torch.pipeline import feature_pipeline as t_fp
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.sfm import two_view as t_tv
from dagsfm_tpu_torch.utils import gps as t_gps
from tests.test_db_matchers import _scene_db
from tests.test_feature_pipeline import image_set  # noqa: F401 (fixture)
from tests.test_torch_database import reference_samples, table_rows
from tests.test_torch_retrieval import replay_chain, replay_key

torch.set_num_threads(1)

W, H, F = 160, 120, 180.0


@pytest.fixture(scope="module")
def scene():
    """A rendered ring of 10 images and the JAX package's features."""
    spec = j_syn.SyntheticSceneSpec(
        num_cameras=10, num_points=40, image_width=W, image_height=H,
        focal=F, seed=3, ring_radius=9.0, point_cloud_extent=3.5)
    images = j_syn.render_images(j_syn.generate(spec))
    jo = j_fp.FeaturePipelineOptions(batch_size=5)
    jo.sift = j_sift.SiftOptions(max_num_features=256,
                                 candidates_per_octave=256, num_octaves=3)
    jfp = j_fp.FeaturePipeline(images, {}, jo)
    jfp.extract_features()
    feats = {"descriptors": {i: np.asarray(d, np.float32)
                             for i, d in jfp.descriptors.items()},
             "masks": dict(jfp.masks), "keypoints": dict(jfp.keypoints),
             "kp_geom": dict(jfp.kp_geom)}
    return images, feats


def _pipelines(images, feats, **options):
    jo = j_fp.FeaturePipelineOptions(**options)
    to = interop.feature_pipeline_options(dataclasses.asdict(jo))
    jp = j_fp.FeaturePipeline(
        images, {i: j_cm.make_simple_camera(i, W, H, focal=F)
                 for i in images}, jo)
    tp = t_fp.FeaturePipeline(
        images, {i: t_cm.make_simple_camera(i, W, H, focal=F)
                 for i in images}, to, device="cpu")
    for p in (jp, tp):
        for k, v in feats.items():
            setattr(p, k, {i: a.copy() for i, a in v.items()})
    return jp, tp


MODES = [
    ("exhaustive", {}, None),
    ("sequential", dict(sequential_overlap=2, loop_detection_period=3,
                        loop_detection_num_images=2), replay_key),
    ("sequential", dict(sequential_overlap=3), None),
    ("retrieval", {}, replay_key),
    ("vocab_tree", {}, replay_chain),
    ("vocab_tree", dict(vocab_tree_rerank=4), replay_chain),
    ("vocab_tree", dict(vocab_tree_rerank=4, spatial_verification=True),
     replay_chain),
    ("global", {}, replay_key),
]


@pytest.mark.parametrize("mode,extra,replay", MODES)
@pytest.mark.parametrize("nn", [3, 50])
def test_select_pairs_in_every_mode(scene, mode, extra, replay, nn,
                                    monkeypatch):
    images, feats = scene
    jp, tp = _pipelines(images, feats, pair_mode=mode, seed=1, **extra)
    jp.opts.retrieval = jp.opts.retrieval._replace(num_neighbors=nn)
    tp.opts.retrieval = tp.opts.retrieval._replace(num_neighbors=nn)
    if replay is not None:
        monkeypatch.setattr(t_rt, "_draw_init", replay(1))
    ref = jp.select_pairs()
    got = tp.select_pairs()
    print(f"{mode} {extra} nn={nn}: {len(got)} pairs")
    assert got == ref
    assert got == sorted(set(got)) or mode in ("sequential", "retrieval")
    assert all(i < j for i, j in got) and len(set(got)) == len(got)


def test_global_mode_without_descriptors_uses_gabor(scene):
    images, _ = scene
    jp, tp = _pipelines(images, {"descriptors": {}}, pair_mode="global")
    for p in (jp, tp):
        p.opts.retrieval = p.opts.retrieval._replace(num_neighbors=3)
    got = tp.select_pairs()
    assert got == jp.select_pairs() and len(got) >= len(images)


def test_match_and_verify_times_pair_selection(scene):
    images, feats = scene
    _, tp = _pipelines(images, feats, pair_mode="sequential",
                       sequential_overlap=2, min_num_inliers=1000)
    tp.match_and_verify()
    assert tp.timings["pair_selection"] >= 0.0 and tp.two_view == {}
    with pytest.raises(ValueError):
        _pipelines(images, feats, pair_mode="nearest")[1].select_pairs()


def test_vocab_tree_pair_mode(image_set):  # noqa: F811
    """Twin of tests/test_feature_pipeline.py's test on the port's own
    features and draws. Spatial verification only removes pairs: with the
    same num_neighbors its pairs are a subset of those without (the
    reference's last assert compares against a union that always holds
    it)."""
    images, _ = image_set
    cams = {i: t_cm.make_simple_camera(i, 256, 256, focal=300.0)
            for i in images}
    o = t_fp.FeaturePipelineOptions(pair_mode="vocab_tree", batch_size=4)
    o.sift = t_fp.sift.SiftOptions(max_num_features=256,
                                   candidates_per_octave=256, num_octaves=3)
    o.retrieval = o.retrieval._replace(num_neighbors=3)
    fp = t_fp.FeaturePipeline(images, cams, o, device="cpu")
    fp.extract_features()
    pairs = fp.select_pairs()
    assert pairs, "vocab tree retrieval returned no pairs"
    assert all(i < j for i, j in pairs)
    assert (1, 2) in pairs or (2, 3) in pairs or (3, 4) in pairs
    fp.opts.spatial_verification = True
    pairs2 = fp.select_pairs()
    assert set(pairs2) <= set(pairs)


# -- the database commands -------------------------------------------------


@pytest.fixture
def db_copies(tmp_path):
    path, rec, centers = _scene_db(tmp_path, n=7)
    jp, tp = str(tmp_path / "j.db"), str(tmp_path / "t.db")
    shutil.copy(path, jp)
    shutil.copy(path, tp)
    return jp, tp, sorted(rec.images)


@pytest.fixture
def replayed_samples(monkeypatch):
    monkeypatch.setattr(t_tv, "_draw_samples",
                        lambda gen, pair_data, num_hyps: reference_samples(
                            pair_data, num_hyps, seed=0))


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--max_num_neighbors", "3", "--max_distance", "1000"],
    ["--max_num_neighbors", "2", "--max_distance", "12"], []])
def test_spatial_matcher_is_the_reference_s(db_copies, replayed_samples,
                                            capsys, flags):
    jp, tp, _ = db_copies
    ref = _run(j_cli.main, ["spatial_matcher", "--database_path", jp]
               + flags, capsys)
    got = _run(t_cli.main, ["spatial_matcher", "--database_path", tp,
                            "--device", "cpu"] + flags, capsys)
    assert got == ref and "pairs verified" in got
    assert table_rows(tp) == table_rows(jp)


def test_spatial_matcher_with_gps_priors(tmp_path, replayed_samples, capsys):
    """--is_gps 1: priors as WGS84 (lat, lon, alt), compared in ENU."""
    path, rec, centers = _scene_db(tmp_path, n=5, with_priors=False)
    with t_fp.scene_io.ColmapDatabase(path) as db:
        for iid, c in centers.items():
            lla = [47.0 + c[0] * 1e-5, 8.0 + c[1] * 1e-5, 400.0 + c[2]]
            db.conn.execute("UPDATE images SET prior_tx=?, prior_ty=?, "
                            "prior_tz=? WHERE image_id=?", (*lla, iid))
        db.conn.commit()
    jp, tp = str(tmp_path / "j.db"), str(tmp_path / "t.db")
    shutil.copy(path, jp)
    shutil.copy(path, tp)
    flags = ["--is_gps", "1", "--max_num_neighbors", "2"]
    ref = _run(j_cli.main, ["spatial_matcher", "--database_path", jp]
               + flags, capsys)
    got = _run(t_cli.main, ["spatial_matcher", "--database_path", tp,
                            "--device", "cpu"] + flags, capsys)
    assert got == ref
    assert table_rows(tp) == table_rows(jp)


@pytest.mark.parametrize("flags", [["--num_iterations", "1"],
                                   ["--batch_size", "2"]])
def test_transitive_matcher_is_the_reference_s(db_copies, replayed_samples,
                                               capsys, flags):
    jp, tp, ids = db_copies
    seed_pairs = [(ids[0], ids[1]), (ids[1], ids[2]), (ids[4], ids[5])]
    assert j_fp.run_matcher_on_database(jp, seed_pairs) == \
        t_fp.run_matcher_on_database(tp, seed_pairs, device="cpu") == 3
    ref = _run(j_cli.main, ["transitive_matcher", "--database_path", jp]
               + flags, capsys)
    got = _run(t_cli.main, ["transitive_matcher", "--database_path", tp,
                            "--device", "cpu"] + flags, capsys)
    assert got == ref and "new pairs verified" in got
    assert table_rows(tp) == table_rows(jp)
    with t_fp.scene_io.ColmapDatabase(tp) as db:
        pairs = {(i, j) for (i, j, *_) in db.read_all_two_view_geometries()}
    assert (ids[0], ids[2]) in pairs


@pytest.mark.parametrize("branching,depth", [(4, 2), (8, 1)])
def test_vocab_tree_builder_and_retriever(db_copies, capsys, monkeypatch,
                                          tmp_path, branching, depth):
    """The builder trains on uint8-scale descriptors and the retriever
    queries with uint8 / 512 (the reference's own mismatch, copied): the
    port's tree (key chain replayed) is the reference's, and each
    package's retriever prints the same rankings on either tree."""
    jp, tp, _ = db_copies
    jt, tt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    flags = ["--branching", str(branching), "--depth", str(depth)]
    ref = _run(j_cli.main, ["vocab_tree_builder", "--database_path", jp,
                            "--vocab_tree_path", jt] + flags, capsys)
    monkeypatch.setattr(t_rt, "_draw_init", replay_chain(0))
    got = _run(t_cli.main, ["vocab_tree_builder", "--database_path", tp,
                            "--vocab_tree_path", tt, "--device", "cpu"]
               + flags, capsys)
    assert got.replace(tt, jt) == ref
    a, b = np.load(jt), np.load(tt)
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(b["proj"], a["proj"])
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-4)
    for tree in (jt, tt):
        argv = ["vocab_tree_retriever", "--vocab_tree_path", tree,
                "--num_images", "3"]
        ref = _run(j_cli.main, argv + ["--database_path", jp], capsys)
        got = _run(t_cli.main, argv + ["--database_path", tp, "--device",
                                       "cpu"], capsys)
        assert got == ref and got.count("img") == 7 * 4
        print(ref, file=sys.stderr)


def test_npz_tree_read_across_packages(tmp_path):
    rng = np.random.default_rng(2)
    train = rng.normal(size=(300, 16)).astype(np.float32)
    jtree = j_vi.build_vocab_tree(train, j_vi.VocabTreeOptions(branching=3))
    ttree = interop.vocab_tree(jtree, device="cpu")
    path = str(tmp_path / "tree.npz")
    t_vi.save_tree(path, ttree)
    back = t_vi.load_tree(path, device="cpu")
    for x, y in zip(back.levels + (back.proj, back.thresholds),
                    ttree.levels + (ttree.proj, ttree.thresholds)):
        assert torch.equal(x, y)
    data = np.load(path)
    np.testing.assert_array_equal(data["level1"], np.asarray(jtree.levels[1]))
    np.testing.assert_array_equal(
        t_vi.quantize(back, torch.as_tensor(train)).numpy(),
        np.asarray(j_vi.quantize(jtree, jnp.asarray(train))))


def test_gps_is_the_reference_s():
    rng = np.random.default_rng(0)
    lla = np.column_stack([rng.uniform(-80, 80, 20),
                           rng.uniform(-179, 179, 20),
                           rng.uniform(-100, 3000, 20)])
    for f in ("ell_to_xyz", "ell_to_enu"):
        np.testing.assert_array_equal(getattr(t_gps, f)(lla),
                                      getattr(j_gps, f)(lla))
    xyz = j_gps.ell_to_xyz(lla)
    np.testing.assert_array_equal(t_gps.xyz_to_ell(xyz), j_gps.xyz_to_ell(xyz))
    np.testing.assert_allclose(t_gps.xyz_to_ell(xyz), lla, atol=1e-6)
    np.testing.assert_array_equal(
        t_gps.ell_to_xyz(lla[:3], t_gps.GRS80_A, t_gps.GRS80_F),
        j_gps.ell_to_xyz(lla[:3], j_gps.GRS80_A, j_gps.GRS80_F))
    np.testing.assert_array_equal(t_gps.ell_to_enu(lla, 10.0, 20.0),
                                  j_gps.ell_to_enu(lla, 10.0, 20.0))
