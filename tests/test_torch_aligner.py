"""The cluster merge of the port against the JAX package: RANSAC Sim(3),
Sim3 algebra, SfMAligner on tests/test_aligner.py's split scenes, the
Reconstruction methods the merge and final BA use, and track selection.

The reference draws RANSAC's 3-point samples inside ransac_umeyama with
jax.random (Gumbel top-3 over the valid rows of its power-of-two padded
arrays), which torch cannot replay. `reference_samples` recomputes them
from the same keys, and the port is given them."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.ops import umeyama as j_um
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import aligner as j_al
from dagsfm_tpu.sfm import track_selection as j_ts
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.ops import rotations as t_rops
from dagsfm_tpu_torch.ops import umeyama as t_um
from dagsfm_tpu_torch.scene.reconstruction import SceneArrays
from dagsfm_tpu_torch.sfm import aligner as t_al
from dagsfm_tpu_torch.sfm import track_selection as t_ts
from tests.test_aligner import make_cluster_recs

torch.set_num_threads(1)


def gumbel_samples(key, n: int, pad: int, iters: int) -> np.ndarray:
    """(iters, 3) rows the reference's ransac_umeyama samples with `key`
    over n valid rows of `pad`."""
    mask = jnp.arange(pad) < n
    keys = jax.random.split(key, iters)
    return np.array(jax.vmap(lambda k: jnp.argsort(
        -(jax.random.gumbel(k, (pad,)) + jnp.where(mask, 0.0, -1e9)))[:3])(
            keys))


def reference_samples(seed: int, iters: int):
    """`SfMAligner._sample_indices` replaying the reference aligner's key
    stream: one split per find_similarity call, padding as it pads."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(self, n):
        state["key"], k = jax.random.split(state["key"])
        pad = 64
        while pad < n:
            pad *= 2
        return torch.tensor(gumbel_samples(k, n, pad, iters),
                            device=self.device)
    return draw


def rot(aa) -> np.ndarray:
    return t_rops.angleaxis_to_rotmat(torch.as_tensor(aa)).numpy()


def port(rec):
    return interop.reconstruction(rec.cameras, rec.images, rec.points3D,
                                  rec._next_point3D_id)


def assert_same_model(a, b, tol=1e-9):
    """Reference model a and port model b: the same ids, registrations,
    tracks and colours, and poses and points to tol."""
    assert list(a.images) == list(b.images)
    assert list(a.points3D) == list(b.points3D)
    for i, im in a.images.items():
        jm = b.images[i]
        assert (im.name, im.registered) == (jm.name, jm.registered)
        np.testing.assert_array_equal(im.point3D_ids, jm.point3D_ids)
        np.testing.assert_allclose(jm.qvec, im.qvec, rtol=tol, atol=tol)
        np.testing.assert_allclose(jm.tvec, im.tvec, rtol=tol, atol=tol)
    for p, pt in a.points3D.items():
        q = b.points3D[p]
        assert pt.track == q.track
        np.testing.assert_array_equal(pt.color, q.color)
        np.testing.assert_allclose(q.xyz, pt.xyz, rtol=tol, atol=tol)
    assert {c: x.params for c, x in a.cameras.items()} == \
        {c: x.params for c, x in b.cameras.items()}


@pytest.mark.parametrize("seed,thr", [(0, 0.05), (1, 0.2), (2, 0.0)])
def test_ransac_umeyama_matches_reference(seed, thr):
    rng = np.random.default_rng(seed)
    N, n, iters = 128, 90, 64
    x = rng.normal(size=(N, 3))
    R = rot(rng.normal(size=3))
    y = 1.7 * x @ R.T + rng.normal(size=3) + rng.normal(0, 0.01, (N, 3))
    y[:20] += rng.normal(0, 1.0, (20, 3))
    mask = np.arange(N) < n
    key = jax.random.PRNGKey(seed + 10)
    ref = j_um.ransac_umeyama(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(mask), key, num_iters=iters,
                              threshold=thr)
    idx = gumbel_samples(key, n, N, iters)
    out = t_um.ransac_umeyama(*(torch.as_tensor(v) for v in (x, y, mask,
                                                             idx)), thr)
    for r, o in zip(ref[:3], out[:3]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert int(out[4]) == int(ref[4]) == (0 if thr == 0 else int(out[4]))
    np.testing.assert_allclose(
        t_um.alignment_errors(*out[:3], torch.as_tensor(x),
                              torch.as_tensor(y)).numpy(),
        np.asarray(j_um.alignment_errors(*ref[:3], jnp.asarray(x),
                                         jnp.asarray(y))), rtol=1e-10)


def test_sample_triplets_are_distinct_valid_rows():
    gen = torch.Generator()
    gen.manual_seed(0)
    mask = torch.arange(50) < 7
    idx = t_um.sample_triplets(gen, mask, 200)
    assert idx.shape == (200, 3) and int(idx.max()) < 7
    assert all(len(set(r.tolist())) == 3 for r in idx)


def test_sim3_algebra_matches_reference():
    rng = np.random.default_rng(0)
    a = (2.0, rot(np.array([0.1, 0.2, 0.3])), rng.normal(size=3))
    b = (0.5, rot(np.array([-0.2, 0.1, 0.4])), rng.normal(size=3))
    x = rng.normal(size=(10, 3))
    ja, jb = j_al.Sim3(*a), j_al.Sim3(*b)
    ta, tb = t_al.Sim3(*a), t_al.Sim3(*b)
    np.testing.assert_array_equal(ta.compose(tb).apply(x),
                                  ja.compose(jb).apply(x))
    np.testing.assert_array_equal(ta.inverse().apply(x),
                                  ja.inverse().apply(x))
    np.testing.assert_allclose(ta.inverse().apply(ta.apply(x)), x,
                               atol=1e-12)
    assert t_al.Sim3.identity().apply(x) is not None
    np.testing.assert_array_equal(t_al.Sim3.identity().apply(x), x)


SPLITS = [dict(num_clusters=3, overlap=4, seed=0),
          dict(num_clusters=2, overlap=5, seed=3)]


@pytest.mark.parametrize("split", SPLITS)
def test_aligner_matches_reference(split, monkeypatch):
    """test_aligner.py's split scenes: the same graph edges and errors,
    tree, anchor, paths and separators, and the merged model to 1e-9."""
    sc, _, recs = make_cluster_recs(**split)
    trecs = [port(r) for r in recs]
    ja = j_al.SfMAligner(recs, j_al.AlignerOptions())
    opts = t_al.AlignerOptions()
    monkeypatch.setattr(t_al.SfMAligner, "_sample_indices",
                        reference_samples(opts.seed, opts.ransac_iters))
    ta = t_al.SfMAligner(trecs, opts, device="cpu")
    jm, tm = ja.align(), ta.align()
    assert list(ja.edge_err) == list(ta.edge_err)
    for k, e in ja.edge_err.items():
        assert ta.edge_err[k] == pytest.approx(e, rel=1e-9)
    # noise-free clusters: every error is at rounding level, so the tree's
    # edge order may differ while its edges may not
    keep = set(ja._largest_cc())
    assert set(ja._mst(keep)) == set(ta._mst(keep))
    assert ja.anchor == ta.anchor
    assert ja.separators == ta.separators
    for k, s in ja.paths.items():
        np.testing.assert_allclose(ta.paths[k].apply(np.eye(3)),
                                   s.apply(np.eye(3)), rtol=1e-9, atol=1e-9)
    assert_same_model(jm, tm)
    assert ja.separator_image_ids(jm) == ta.separator_image_ids(tm)
    errs = j_syn.pose_errors(jm, sc)
    assert tm.num_reg_images() == 18 and errs["ate"] < 0.01, errs


def test_aligner_ignores_a_disconnected_cluster(monkeypatch):
    sc, _, recs = make_cluster_recs(num_clusters=3, overlap=4, seed=4)
    stray = j_syn.to_reconstruction(j_syn.generate(
        j_syn.SyntheticSceneSpec(num_cameras=6, num_points=80, seed=99)))
    for im in stray.images.values():
        im.name = "stray_" + im.name
    recs = recs + [stray]
    trecs = [port(r) for r in recs]
    opts = t_al.AlignerOptions()
    monkeypatch.setattr(t_al.SfMAligner, "_sample_indices",
                        reference_samples(opts.seed, opts.ransac_iters))
    jm = j_al.SfMAligner(recs).align()
    tm = t_al.SfMAligner(trecs, opts, device="cpu").align()
    assert tm.num_reg_images() == 18
    assert_same_model(jm, tm)


def test_aligner_draws_its_own_samples():
    """Without the reference's samples the port's generator gives a merge
    within test_aligner.py's limits, the same on a second run."""
    sc, _, recs = make_cluster_recs()
    merged = [t_al.SfMAligner([port(r) for r in recs], device="cpu").align()
              for _ in range(2)]
    errs = j_syn.pose_errors(merged[0], sc)
    assert merged[0].num_reg_images() == 18 and errs["ate"] < 0.01, errs
    assert errs["rot_err_deg_max"] < 0.1, errs
    for i in merged[0].images:
        np.testing.assert_array_equal(merged[0].images[i].qvec,
                                      merged[1].images[i].qvec)


@pytest.fixture(scope="module")
def small_rec():
    sc = j_syn.generate(j_syn.SyntheticSceneSpec(num_cameras=8,
                                                 num_points=150, seed=5))
    rec = j_syn.to_reconstruction(sc)
    rng = np.random.default_rng(1)
    for pt in rec.points3D.values():
        pt.error = float(rng.uniform(0.1, 2.0)) if rng.random() < 0.9 \
            else -1.0
        pt.color = rng.integers(0, 255, 3).astype(np.uint8)
    return rec


def test_reconstruction_methods_match_reference(small_rec):
    jr, tr = copy.deepcopy(small_rec), port(small_rec)
    assert jr.find_common_reg_image_ids(jr) == \
        tr.find_common_reg_image_ids(tr)
    p1, p2 = sorted(jr.points3D)[:2]
    assert jr.merge_points3D(p1, p2) == tr.merge_points3D(p1, p2)
    rng = np.random.default_rng(2)
    imgs = {i: rng.random((768, 1024)) for i in list(jr.images)[:3]}
    imgs[list(jr.images)[3]] = rng.random((768, 1024, 3))
    assert jr.extract_colors(imgs) == tr.extract_colors(imgs) > 0
    R = rot(np.array([0.3, -0.2, 0.5]))
    jr.transform(1.7, R, np.array([1.0, -2.0, 0.5]))
    tr.transform(1.7, R, np.array([1.0, -2.0, 0.5]))
    assert_same_model(jr, tr, tol=1e-12)
    for im_j, im_t in zip(jr.images.values(), tr.images.values()):
        assert np.sign(im_j.qvec[0]) == np.sign(im_t.qvec[0])
    arrays, ids = tr.to_arrays("cpu")
    bumped = arrays._replace(points_xyz=arrays.points_xyz + 0.25,
                             image_tvec=arrays.image_tvec - 0.5)
    assert isinstance(bumped, SceneArrays)
    tr.update_from_arrays(bumped, ids)
    ja, jids = jr.to_arrays()
    jr.update_from_arrays(ja._replace(points_xyz=ja.points_xyz + 0.25,
                                      image_tvec=ja.image_tvec - 0.5), jids)
    assert_same_model(jr, tr, tol=1e-12)


def test_merge_matches_reference(small_rec):
    """Half the images of a model merged into the other half under a
    Sim(3): common images keep self's pose, new images keep their id
    where it is free, tracks through common images join."""
    a = copy.deepcopy(small_rec)
    b = copy.deepcopy(small_rec)
    for i in list(a.images)[5:]:
        a.deregister_image(i)
        del a.images[i]
    for i in list(b.images)[:3]:
        b.deregister_image(i)
    b.images[99] = b.images.pop(list(b.images)[-1])   # a taken id moves
    b.images[99].image_id = 99
    for pt in b.points3D.values():
        pt.track = [(99 if i == 8 else i, k) for (i, k) in pt.track]
    ta, tb = port(a), port(b)
    R = rot(np.array([-0.1, 0.2, 0.3]))
    a.merge(b, 0.8, R, np.array([0.5, 0.0, -1.0]))
    ta.merge(tb, 0.8, R, np.array([0.5, 0.0, -1.0]))
    assert_same_model(a, ta, tol=1e-12)
    assert a.num_reg_images() == 8


@pytest.mark.parametrize("cell,min_tracks", [(100, 200), (300, 20)])
def test_track_selection_is_identical(small_rec, cell, min_tracks):
    kw = dict(long_track_length_threshold=5,
              image_grid_cell_size_pixels=cell,
              min_num_optimized_tracks_per_view=min_tracks)
    ref = j_ts.select_tracks(small_rec, j_ts.TrackSelectionOptions(**kw))
    sel = t_ts.select_tracks(port(small_rec),
                             t_ts.TrackSelectionOptions(**kw))
    assert sel == ref and 0 < len(sel) <= len(small_rec.points3D)
