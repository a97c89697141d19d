"""The port's COLMAP files and database against the JAX package on the
CPU: text and PLY models byte for byte, every database table row for
row (blob for blob), the merge and its id map, the pair-id packing, the
feature pipeline's checkpoint (write, resume, load), the pose edges read
back from a database, and matching plus verification on a database of
features.

torch cannot replay jax.random, so where RANSAC runs the reference's
own sample indices (`ops/ransac.py::_sample_indices` on the keys its
`verify_pairs` splits, one per pair in list order, over each pair padded
to its bucket of at least 64) are fed to the port, which must then agree
exactly: the same inlier sets, and R and t to 1e-9."""
import contextlib
import os
import shutil
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import plant_features
from dagsfm_tpu.ops import ransac as j_rnsc
from dagsfm_tpu.pipeline import feature_pipeline as j_fp
from dagsfm_tpu.scene import cameras as j_cm
from dagsfm_tpu.scene import io as j_io
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import two_view as j_tv
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.ops import rotations as t_rops
from dagsfm_tpu_torch.ops import two_view_classify as t_tvc
from dagsfm_tpu_torch.pipeline import feature_pipeline as t_fp
from dagsfm_tpu_torch.scene import cameras as t_cm
from dagsfm_tpu_torch.scene import io as t_io
from dagsfm_tpu_torch.sfm import two_view as t_tv
from tests.test_db_matchers import _scene_db

torch.set_num_threads(1)

TABLES = ("cameras", "images", "keypoints", "descriptors", "matches",
          "two_view_geometries")


def table_rows(path: str) -> dict:
    with contextlib.closing(sqlite3.connect(path)) as c:
        return {t: c.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in TABLES}


def reference_samples(pair_data, num_hyps: int, seed: int) -> list:
    """The (H, 5) indices the reference's verify_pairs draws for each
    pair: one split of PRNGKey(seed) per pair, in list order, Gumbel
    top-5 over the pair padded to its bucket."""
    key = jax.random.PRNGKey(seed)
    out = []
    for (_, a, _, _) in pair_data:
        n = 64
        while n < len(a):
            n *= 2
        mask = np.zeros(n, bool)
        mask[:len(a)] = True
        key, sub = jax.random.split(key)
        out.append(np.asarray(j_rnsc._sample_indices(
            sub, num_hyps, 5, n, jnp.asarray(mask))))
    return out


# --------------------------------------------------------------------------
# model files


@pytest.fixture(scope="module")
def model():
    """A reference reconstruction with an unregistered image, coloured
    points and errors, and its port copy."""
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(num_cameras=5,
                                                 num_points=60, seed=7))
    jrec = j_syn.to_reconstruction(sc)
    jrec.images[3].registered = False
    rng = np.random.default_rng(0)
    for pt in jrec.points3D.values():
        pt.color = rng.integers(0, 256, 3).astype(np.uint8)
        pt.error = float(rng.uniform(0, 2))
    return jrec, interop.reconstruction(jrec.cameras, jrec.images,
                                        jrec.points3D)


def _same_model(a, b):
    assert {c: (x.model_id, x.width, x.height, tuple(x.params))
            for c, x in a.cameras.items()} == \
        {c: (x.model_id, x.width, x.height, tuple(x.params))
         for c, x in b.cameras.items()}
    assert list(a.images) == list(b.images)
    for i, im in a.images.items():
        o = b.images[i]
        assert (im.name, im.camera_id, im.registered) == \
            (o.name, o.camera_id, o.registered)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(im, f), getattr(o, f))
    assert list(a.points3D) == list(b.points3D)
    for pid, pt in a.points3D.items():
        o = b.points3D[pid]
        np.testing.assert_array_equal(pt.xyz, o.xyz)
        np.testing.assert_array_equal(pt.color, o.color)
        assert pt.error == o.error and list(pt.track) == list(o.track)


def test_text_and_ply_files_are_the_reference_s(model, tmp_path):
    jrec, trec = model
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    j_io.write_model_text(jrec, jdir)
    t_io.write_model_text(trec, tdir)
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(jdir, f), "rb") as a, \
                open(os.path.join(tdir, f), "rb") as b:
            assert a.read() == b.read(), f
    j_io.write_model_ply(jrec, jdir + ".ply")
    t_io.write_model_ply(trec, tdir + ".ply")
    with open(jdir + ".ply", "rb") as a, open(tdir + ".ply", "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data.count(b"\n") == 10 + len(jrec.points3D)
    # each package reads the other's files to equal models, every image
    # registered (only registered images are written)
    back_t, back_j = t_io.read_model_text(jdir), j_io.read_model_text(tdir)
    _same_model(back_t, back_j)
    assert 3 not in back_t.images and len(back_t.images) == 4
    assert all(im.registered for im in back_t.images.values())
    assert back_t._next_point3D_id == back_j._next_point3D_id


# --------------------------------------------------------------------------
# the database


def _fill(io, cm, path):
    """The same cameras, images with priors, keypoints (2 and 6 columns),
    descriptors, matches and geometries, one pair given as (j, i)."""
    rng = np.random.default_rng(3)
    with io.ColmapDatabase(path) as db:
        db.add_camera(cm.Camera(1, cm.SIMPLE_RADIAL, 640, 480,
                                (500.0, 320.0, 240.0, -0.01)))
        db.add_camera(cm.Camera(2, cm.PINHOLE, 800, 600,
                                (700.0, 710.0, 400.0, 300.0),
                                prior_focal=False))
        ids = [db.add_image("a.jpg", 1, prior_tvec=(1.0, 2.0, 3.0)),
               db.add_image("b.jpg", 2, prior_qvec=(1.0, 0, 0, 0),
                            prior_tvec=(0.5, -1.0, 2.0)),
               db.add_image("c.jpg", 1, image_id=7)]
        db.add_keypoints(ids[0], rng.uniform(0, 600, (50, 2)))
        db.add_keypoints(ids[1], rng.uniform(0, 600, (40, 6)))
        db.add_keypoints(ids[2], rng.uniform(0, 600, (30, 2)))
        for i, n in zip(ids, (50, 40, 30)):
            db.add_descriptors(i, rng.integers(0, 256, (n, 128)))
        m = np.stack([rng.permutation(30)[:20], rng.permutation(40)[:20]], 1)
        db.add_matches(ids[0], ids[1], m)
        db.add_matches(ids[2], ids[0], m[:, ::-1] % 30)
        db.add_two_view_geometry(ids[0], ids[1], m[:12])
        db.add_two_view_geometry(ids[2], ids[0], (m[:, ::-1] % 30)[:9],
                                 config=3, F=rng.normal(size=(3, 3)),
                                 E=rng.normal(size=(3, 3)))
    return ids


def test_tables_are_the_reference_s_row_for_row(tmp_path):
    jp, tp = str(tmp_path / "j.db"), str(tmp_path / "t.db")
    ids = _fill(j_io, j_cm, jp)
    assert _fill(t_io, t_cm, tp) == ids == [1, 2, 7]
    assert table_rows(tp) == table_rows(jp)
    # each package reads the other's file
    with j_io.ColmapDatabase(tp) as jdb, t_io.ColmapDatabase(jp) as tdb:
        assert {c: tuple(x) for c, x in tdb.read_cameras().items()} == \
            {c: tuple(x) for c, x in jdb.read_cameras().items()}
        assert tdb.read_images() == jdb.read_images()
        assert list(tdb.read_image_priors()) == [1, 2]
        for i, p in jdb.read_image_priors().items():
            np.testing.assert_array_equal(tdb.read_image_priors()[i], p)
        for i in ids:
            np.testing.assert_array_equal(tdb.read_keypoints(i),
                                          jdb.read_keypoints(i))
            np.testing.assert_array_equal(tdb.read_descriptors(i),
                                          jdb.read_descriptors(i))
        assert tdb.read_keypoints(1).shape == (50, 4)
        assert tdb.read_keypoints(1).dtype == np.float32
        for a, b in ((1, 2), (2, 1), (7, 1), (1, 7), (2, 7)):
            np.testing.assert_array_equal(tdb.read_matches(a, b),
                                          jdb.read_matches(a, b))
        tg = list(tdb.read_all_two_view_geometries())
        jg = list(jdb.read_all_two_view_geometries())
        assert [g[:2] + (g[3],) for g in tg] == \
            [g[:2] + (g[3],) for g in jg] == [(1, 2, 2), (1, 7, 3)]
        for a, b in zip(tg, jg):
            for x, y in zip(a[2:], b[2:]):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(tg[0][5], np.eye(3))    # E not given
        assert tdb.num_two_view_geometries() == 2


def test_merge_is_the_reference_s(tmp_path):
    maps, rows = {}, {}
    for pkg, io, cm in (("j", j_io, j_cm), ("t", t_io, t_cm)):
        p1, p2, po = (str(tmp_path / f"{pkg}{k}.db") for k in (1, 2, "o"))
        _fill(io, cm, p1)
        rng = np.random.default_rng(5)
        with io.ColmapDatabase(p2) as db:
            db.add_camera(cm.Camera(1, cm.SIMPLE_PINHOLE, 320, 240,
                                    (300.0, 160.0, 120.0)))
            shared = db.add_image("b.jpg", 1, image_id=3)   # name in db1
            taken = db.add_image("d.jpg", 1, image_id=7)    # id taken in db1
            free = db.add_image("e.jpg", 1, image_id=20)    # id free
            for i in (shared, taken, free):
                db.add_keypoints(i, rng.uniform(0, 300, (25, 2)))
                db.add_descriptors(i, rng.integers(0, 256, (25, 128)))
            m = np.stack([np.arange(10), np.arange(10)[::-1]], 1)
            db.add_matches(free, taken, m)
            db.add_two_view_geometry(free, shared, m[:6])
        with io.ColmapDatabase(p1) as d1, io.ColmapDatabase(p2) as d2, \
                io.ColmapDatabase(po) as out:
            maps[pkg] = io.ColmapDatabase.merge(d1, d2, out)
        rows[pkg] = table_rows(po)
    assert maps["t"] == maps["j"] == {3: 2, 7: 8, 20: 20}
    assert rows["t"] == rows["j"]


@pytest.mark.parametrize("a,b", [(1, 2), (2, 1), (5, 5),
                                 (2 ** 31 - 2, 2 ** 31 - 3),
                                 (1, 2 ** 31 - 2), (2 ** 31 - 2, 0)])
def test_pair_ids_are_the_reference_s(a, b):
    pid = t_io.pair_id_from_image_ids(a, b)
    assert pid == j_io.pair_id_from_image_ids(a, b)
    assert t_io.image_ids_from_pair_id(pid) == \
        j_io.image_ids_from_pair_id(pid) == (min(a, b), max(a, b))
    assert t_io.pair_id_from_image_ids(np.int32(a), np.int32(b)) == pid
    if min(a, b) >= 2:
        assert pid > 2 ** 31


# --------------------------------------------------------------------------
# the feature pipeline's database


def _pose(sc, i, j):
    Rij = sc.R[j - 1] @ sc.R[i - 1].T
    t = sc.t[j - 1] - Rij @ sc.t[i - 1]
    return Rij, t / np.linalg.norm(t)


def _skew(t):
    return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])


@pytest.fixture(scope="module")
def pipelines():
    """The reference pipeline on planted features with hand-made
    verified pairs cycling CALIBRATED (E), UNCALIBRATED (F) and PLANAR
    (H) records; the port pipeline given the same."""
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(
        num_cameras=6, num_points=150, pixel_noise=0.3, seed=2,
        max_track_length=6))
    kps, descs, masks = plant_features(sc, K=256)
    rng = np.random.default_rng(1)
    for i in masks:      # masked slots inside the kept range too
        masks[i][np.nonzero(masks[i])[0][-5:-2]] = False
    K = sc.camera.calibration_matrix()
    Kinv = np.linalg.inv(K)
    jfp = j_fp.FeaturePipeline({i: None for i in kps},
                               {i: sc.camera for i in kps})
    jfp.keypoints, jfp.descriptors, jfp.masks = kps, descs, masks
    configs = (t_tvc.CALIBRATED, t_tvc.UNCALIBRATED, t_tvc.PLANAR)
    n = 0
    for i in sorted(kps):
        for j in sorted(kps):
            common = np.nonzero(sc.visible[i - 1] & sc.visible[j - 1])[0]
            if j <= i or len(common) < 15:
                continue
            slot = {k: np.cumsum(sc.visible[k - 1]) - 1 for k in (i, j)}
            inl = np.stack([slot[i][common], slot[j][common]], 1)
            extra = rng.integers(0, 200, (4, 2))
            R, t = _pose(sc, i, j)
            E = _skew(t) @ R
            config = configs[n % 3]
            rec = j_fp.TwoViewRecord(
                R, t, inl.astype(np.uint32), len(inl), config,
                E=E if config == t_tvc.CALIBRATED else None,
                F=Kinv.T @ E @ Kinv if config == t_tvc.UNCALIBRATED else None,
                H=K @ (R + 0.1 * np.outer(t, [0, 0, 1])) @ Kinv
                if config == t_tvc.PLANAR else None)
            key = (j, i) if n == 4 else (i, j)    # one pair given as (j, i)
            if key != (i, j):
                rec.inlier_matches = rec.inlier_matches[:, ::-1].copy()
                extra = extra[:, ::-1]
            jfp.two_view[key] = rec
            jfp.matches[key] = np.concatenate(
                [rec.inlier_matches, extra]).astype(np.uint32)
            n += 1
    tfp = t_fp.FeaturePipeline({i: None for i in kps},
                               {i: interop.camera(sc.camera) for i in kps},
                               device="cpu")
    tfp.keypoints, tfp.descriptors, tfp.masks = kps, descs, masks
    tfp.matches = {k: m.copy() for k, m in jfp.matches.items()}
    tfp.two_view = interop.two_view_records(jfp.two_view)
    return jfp, tfp


def test_pipeline_database_is_the_reference_s(pipelines, tmp_path):
    jfp, tfp = pipelines
    assert len(jfp.two_view) >= 9
    jp, tp = str(tmp_path / "j.db"), str(tmp_path / "t.db")
    jfp.write_database(jp)
    tfp.write_database(tp)
    rows = table_rows(tp)
    assert rows == table_rows(jp)
    assert {r[4] for r in rows["two_view_geometries"]} == {2, 3, 4}
    # has_checkpoint: geometries, none, no file
    fp_path = str(tmp_path / "features.db")
    empty = t_fp.FeaturePipeline({i: None for i in tfp.keypoints},
                                 tfp.cameras, device="cpu")
    empty.keypoints, empty.descriptors, empty.masks = \
        tfp.keypoints, tfp.descriptors, tfp.masks
    empty.write_database(fp_path)
    for path in (jp, fp_path, str(tmp_path / "missing.db"), None):
        assert t_fp.FeaturePipeline.has_checkpoint(path) == \
            j_fp.FeaturePipeline.has_checkpoint(path)
    assert t_fp.FeaturePipeline.has_checkpoint(jp)
    assert not t_fp.FeaturePipeline.has_checkpoint(fp_path)


def test_load_from_the_reference_database(pipelines, tmp_path):
    jfp, _ = pipelines
    jp = str(tmp_path / "j.db")
    jfp.write_database(jp)
    jc, ji, jg = j_fp.FeaturePipeline({}, {}).load_from_database(jp)
    resume = t_fp.FeaturePipeline({}, {}, device="cpu", database_path=jp)
    tc, ti, tg = resume.run()           # the checkpoint: nothing computed
    assert resume.timings == {}
    assert {c: tuple(x) for c, x in tc.items()} == \
        {c: tuple(x) for c, x in jc.items()}
    assert list(ti) == list(ji)
    for i, im in ji.items():
        assert (ti[i].name, ti[i].camera_id) == (im.name, im.camera_id)
        np.testing.assert_array_equal(ti[i].xys, im.xys)
        assert ti[i].xys.dtype == np.float64      # float32 values
        kp = jfp.keypoints[i][jfp.masks[i]]
        np.testing.assert_array_equal(ti[i].xys, kp.astype(np.float32))
    assert tg.num_keypoints == jg.num_keypoints
    assert list(tg.pair_matches) == list(jg.pair_matches)
    for k, m in jg.pair_matches.items():
        np.testing.assert_array_equal(tg.pair_matches[k], m)
    # the same correspondences per pair as the in-memory mapper inputs
    _, _, mem = pipelines[1].to_mapper_inputs()
    for (i, j), m in mem.pair_matches.items():
        np.testing.assert_array_equal(tg.matches_between(i, j), m)


def test_pose_edges_from_the_database(pipelines, tmp_path):
    jfp, tfp = pipelines
    jp = str(tmp_path / "j.db")
    jfp.write_database(jp)
    ref = j_fp.load_two_view_geometries_from_database(jp)
    got = t_fp.load_two_view_geometries_from_database(jp, device="cpu")
    assert list(got) == list(ref)
    assert {v[3] for v in got.values()} == {2, 3, 4}
    for k, (R, t, n, config) in ref.items():
        gR, gt, gn, gc = got[k]
        assert (gn, gc) == (n, config)
        np.testing.assert_allclose(gR, R, rtol=0, atol=1e-9)
        np.testing.assert_allclose(gt, t, rtol=0, atol=1e-9)
    # E and F records give the in-memory (true) rotation back
    # (F/E/H are stored as given, so a pair given as (j, i) keeps the
    # (i, j) pose its record was made with)
    for k, rec in tfp.two_view.items():
        if rec.config in (t_tvc.CALIBRATED, t_tvc.UNCALIBRATED):
            np.testing.assert_allclose(got[tuple(sorted(k))][0], rec.R,
                                       atol=1e-5)


# --------------------------------------------------------------------------
# matching and verification on a database


def test_run_matcher_on_database_is_the_reference_s(tmp_path, monkeypatch):
    path, rec, _ = _scene_db(tmp_path)
    jp, tp = str(tmp_path / "j.db"), str(tmp_path / "t.db")
    shutil.copy(path, jp)
    shutil.copy(path, tp)
    ids = sorted(rec.images)
    pairs = [(a, b) for a in ids for b in ids if a < b]
    drawn = []

    def samples(generator, pair_data, num_hyps):
        drawn.append(len(pair_data))
        return reference_samples(pair_data, num_hyps, seed=0)

    monkeypatch.setattr(t_tv, "_draw_samples", samples)
    n_ref = j_fp.run_matcher_on_database(jp, pairs)
    n = t_fp.run_matcher_on_database(tp, pairs, device="cpu")
    assert n == n_ref >= 10 and drawn and drawn[0] >= n
    assert table_rows(tp) == table_rows(jp)
    with t_io.ColmapDatabase(tp) as db:
        assert db.num_two_view_geometries() == n


def _two_view(seed, n, outlier_frac=0.3, f=800.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 8]
    a = rng.normal(size=3) * 0.1
    R = t_rops.angleaxis_to_rotmat(torch.as_tensor(a)).numpy()
    t = np.array([1.0, 0.2, 0.1]) + rng.normal(size=3) * 0.1
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    x1 = x1 + rng.normal(size=x1.shape) * 0.5 / f
    x2 = x2 + rng.normal(size=x2.shape) * 0.5 / f
    bad = rng.random(n) < outlier_frac
    x2[bad] = rng.uniform(-0.4, 0.4, (bad.sum(), 2))
    return x1, x2, (4.0 / f) ** 2


def test_verify_pairs_is_the_reference_s():
    # lengths in the reference's 64 and 128 buckets, which its matcher
    # test above compiled
    pair_data = [((k, k + 1), *_two_view(k, n)) for k, n in
                 enumerate((40, 100, 60, 120))]
    ref = j_tv.verify_pairs(pair_data, seed=3)
    got = t_tv.verify_pairs(pair_data, device="cpu",
                            sample_idx=reference_samples(pair_data, 256, 3))
    assert list(got) == list(ref)
    for k, (R, t, ninl, nf, inl, valid) in ref.items():
        gR, gt, gn, gf, ginl, gv = got[k]
        np.testing.assert_allclose(gR, R, rtol=0, atol=1e-9)
        np.testing.assert_allclose(gt, t, rtol=0, atol=1e-9)
        assert (gn, gf, gv) == (ninl, nf, valid) and gv
        np.testing.assert_array_equal(ginl, inl)
    # the port's own draws: repeatable, and the inliers found
    a = t_tv.verify_pairs(pair_data, seed=3, device="cpu")
    b = t_tv.verify_pairs(pair_data, seed=3, device="cpu")
    for k in a:
        np.testing.assert_array_equal(a[k][4], b[k][4])
        assert a[k][2] >= 0.6 * len(pair_data[k[0]][1])
