"""Port vocab-tree visual index (features/visual_index.py) vs the JAX
reference on the same numpy inputs.

A tree the JAX package built is carried across by `interop.vocab_tree`,
so both packages quantise with the same centroids; then words,
signatures, queries (with and without Hamming re-ranking), match_words
and vote_and_verify must be the reference's. A signature bit may differ
only where the projected descriptor lies within SIG_BORDER of its
word's threshold (XLA's and torch's f32 products round apart): a word's
median threshold is one of its own descriptors' projections, so those
bits are flagged and counted. `build_vocab_tree` with the reference's key chain
replayed into `retrieval._draw_init` gives the reference's projection to
the bit (a numpy draw in the same call order) and its levels and
thresholds to rel 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.features import visual_index as j_vi
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.features import retrieval as t_rt
from dagsfm_tpu_torch.features import visual_index as t_vi
from tests.test_torch_retrieval import replay_chain
from tests.test_visual_index import _make_scene_descs, _unit

torch.set_num_threads(1)

SIG_BORDER = 1e-5


def _keypoints(rng, n):
    return np.column_stack([rng.uniform(0, 1000, (n, 2)),
                            rng.uniform(1, 3, n),
                            rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """(reference tree, its port, descriptors, keypoints, options)."""
    rng = np.random.default_rng(7)
    descs, groups = _make_scene_descs(rng, num_images=6, num_groups=3)
    opts = j_vi.VocabTreeOptions(branching=4, depth=2, hamming_threshold=30)
    jtree = j_vi.build_vocab_tree(np.concatenate(descs), opts, seed=1)
    ttree = interop.vocab_tree(jtree, device="cpu")
    kps = [_keypoints(rng, len(d)) for d in descs]
    return jtree, ttree, descs, kps, opts


def test_quantize_and_signatures_equal(carried):
    jtree, ttree, descs, _, _ = carried
    x = np.concatenate(descs)
    ref_w = np.asarray(j_vi.quantize(jtree, jnp.asarray(x)))
    got_w = t_vi.quantize(ttree, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got_w, ref_w)
    ref_s = np.asarray(j_vi.hamming_signatures(jtree, jnp.asarray(x),
                                               jnp.asarray(ref_w)))
    got_s = t_vi.hamming_signatures(ttree, torch.as_tensor(x),
                                    torch.as_tensor(got_w)).numpy()
    z = x.astype(np.float64) @ np.asarray(jtree.proj, np.float64)
    thr = np.asarray(jtree.thresholds)[ref_w]
    flag = np.abs(z - thr) <= SIG_BORDER * np.maximum(1.0, np.abs(thr))
    print(f"signature bits near their threshold: {int(flag.sum())}, "
          f"differing {int((got_s != ref_s).sum())}")
    assert got_s.dtype == np.uint8
    assert ((got_s != ref_s) & ~flag).sum() == 0
    # (..., D) shapes keep their leading axes
    got3 = t_vi.quantize(ttree, torch.as_tensor(np.stack(descs[:2])))
    assert got3.shape == (2, len(descs[0]))


@pytest.fixture(scope="module")
def indices(carried):
    jtree, ttree, descs, kps, opts = carried
    jidx, tidx = j_vi.VisualIndex(jtree, opts), \
        t_vi.VisualIndex(ttree, interop.vocab_tree_options(opts._asdict()))
    for i, (d, kp) in enumerate(zip(descs, kps)):
        mask = np.ones(len(d), bool)
        mask[i::5] = False
        jidx.add(i, d, kp, mask=mask)
        tidx.add(i, d, kp, mask=mask)
    return jidx, tidx


@pytest.mark.parametrize("num,rerank", [(3, 0), (5, 0), (3, 3), (2, 5)])
def test_query_equal(indices, num, rerank):
    jidx, tidx = indices
    for q in jidx.image_ids:
        ref = jidx.query(q, num_images=num, rerank=rerank)
        got = tidx.query(q, num_images=num, rerank=rerank)
        assert [i for i, _ in got] == [i for i, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref],
                                   rtol=1e-6)


def test_hamming_score_match_words_and_vote_and_verify(indices, carried):
    jidx, tidx = indices
    kps = carried[3]
    for q in jidx.image_ids:
        for d in jidx.image_ids:
            if q == d:
                continue
            assert tidx._hamming_score(q, d) == jidx._hamming_score(q, d)
            ref = jidx.match_words(q, d)
            got = tidx.match_words(q, d)
            assert got.dtype == np.int64 and got.shape[1] == 2
            np.testing.assert_array_equal(got, ref)
            kq, kd = tidx._geom[q], tidx._geom[d]
            ref_v = j_vi.vote_and_verify(kq, kd, ref)
            got_v = t_vi.vote_and_verify(kq, kd, got)
            assert got_v[0] == ref_v[0]
            np.testing.assert_array_equal(got_v[1], ref_v[1])
    keep = np.arange(len(kps[0])) % 5 != 0          # image 0's mask
    np.testing.assert_array_equal(tidx._geom[0], kps[0][keep])


def test_build_vocab_tree_with_replayed_key_chain(monkeypatch):
    rng = np.random.default_rng(0)
    train = _unit(rng.standard_normal((700, 32))).astype(np.float32)
    train[:3] = train[3]                     # a node may hold duplicates
    for opts in (j_vi.VocabTreeOptions(branching=4, depth=2),
                 j_vi.VocabTreeOptions(branching=8, depth=3,
                                       kmeans_iters=4, embedding_bits=32)):
        ref = j_vi.build_vocab_tree(train, opts, seed=2)
        monkeypatch.setattr(t_rt, "_draw_init", replay_chain(2))
        got = t_vi.build_vocab_tree(
            train, interop.vocab_tree_options(opts._asdict()), seed=2,
            device="cpu")
        np.testing.assert_array_equal(got.proj.numpy(), np.asarray(ref.proj))
        assert len(got.levels) == len(ref.levels)
        for a, b in zip(got.levels, ref.levels):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(got.thresholds.numpy(),
                                   np.asarray(ref.thresholds), rtol=1e-5,
                                   atol=1e-6)
        assert got.num_words == ref.num_words


def test_vote_and_verify_degenerate_cases():
    kp = np.array([[0, 0, 1, 0], [10, 0, 1, 0], [0, 10, 1, 0]], np.float32)
    for m in (np.zeros((0, 2), np.int64), np.array([[0, 0], [1, 1]])):
        ref = j_vi.vote_and_verify(kp, kp, m)
        got = t_vi.vote_and_verify(kp, kp, m)
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])


# -- twins of tests/test_visual_index.py, the port's own draws ------------


def test_quantize_deterministic_and_in_range():
    rng = np.random.default_rng(0)
    train = _unit(rng.standard_normal((512, 32))).astype(np.float32)
    opts = t_vi.VocabTreeOptions(branching=4, depth=2)
    tree = t_vi.build_vocab_tree(train, opts, device="cpu")
    w1 = t_vi.quantize(tree, torch.as_tensor(train[:64])).numpy()
    w2 = t_vi.quantize(tree, torch.as_tensor(train[:64])).numpy()
    assert (w1 == w2).all()
    assert (w1 >= 0).all() and (w1 < tree.num_words).all()
    assert len(np.unique(t_vi.quantize(tree, torch.as_tensor(train))
                         .numpy())) > 4


def test_query_ranks_same_group_first():
    rng = np.random.default_rng(1)
    descs, groups = _make_scene_descs(rng)
    opts = t_vi.VocabTreeOptions(branching=4, depth=2)
    tree = t_vi.build_vocab_tree(np.concatenate(descs), opts, device="cpu")
    index = t_vi.VisualIndex(tree, opts)
    for i, d in enumerate(descs):
        index.add(i, d)
    hits = 0
    for i in range(len(descs)):
        top = index.query(i, num_images=2)
        hits += sum(1 for j, _ in top if groups[j] == groups[i])
    assert hits >= len(descs)


def test_hamming_rerank_and_match_words():
    rng = np.random.default_rng(2)
    descs, groups = _make_scene_descs(rng, num_images=4, num_groups=2)
    opts = t_vi.VocabTreeOptions(branching=4, depth=1, hamming_threshold=40)
    tree = t_vi.build_vocab_tree(np.concatenate(descs), opts, device="cpu")
    index = t_vi.VisualIndex(tree, opts)
    for i, d in enumerate(descs):
        index.add(i, d)
    assert len(index.query(0, num_images=3, rerank=3)) == 3
    s_same = index._hamming_score(0, 2)
    assert s_same >= index._hamming_score(0, 1)
    assert s_same >= index._hamming_score(0, 3)
    m = index.match_words(0, 2)
    assert m.ndim == 2 and m.shape[1] == 2 and len(m) > 0


def test_vote_and_verify_recovers_similarity_inliers():
    rng = np.random.default_rng(3)
    n = 60
    x = rng.uniform(0, 1000, (n, 2))
    scale = rng.uniform(1.0, 2.0, n)
    ori = rng.uniform(-np.pi, np.pi, n)
    kp1 = np.column_stack([x, scale, ori]).astype(np.float32)
    s, th = 1.5, 0.3
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    y = (s * (R @ x.T)).T + np.array([50.0, -30.0])
    kp2 = np.column_stack([y, scale * s, ori + th]).astype(np.float32)
    matches = np.column_stack([np.arange(n), np.arange(n)])
    bad = rng.choice(n, 20, replace=False)
    matches[bad, 1] = rng.permutation(matches[bad, 1])
    score, inl = t_vi.vote_and_verify(kp1, kp2, matches, image_extent=2048.0)
    assert score >= 30
    good = np.setdiff1d(np.arange(n), bad)
    assert inl[good].mean() > 0.8
