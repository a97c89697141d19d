"""Port pair selection (features/retrieval.py) vs the JAX reference on the
same numpy inputs.

k-means' initial centroids are the one draw torch cannot replay
(`jax.random.choice`): `replay_key` / `replay_chain` put the reference's
draws into `retrieval._draw_init`. With them the centroids agree to rel
1e-5 (only the summation order differs). Assignments are held under a
borderline rule: a descriptor is flagged when its best and second-best
squared distance to the reference's centroids are within BORDER of each
other (relative to the largest squared distance); outside the flagged
ones no assignment may differ. On the reference's own inputs, which are
well separated, the pair lists are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.features import retrieval as j_rt
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.features import retrieval as t_rt
from tests.test_loop_closure import _ring_descriptors

torch.set_num_threads(1)

BORDER = 1e-5


def _choice(key, n, k):
    return torch.as_tensor(np.array(
        jax.random.choice(key, n, (k,), replace=False)))


def replay_key(seed):
    """`_draw_init` as the reference's kmeans_fit(…, PRNGKey(seed), …)
    draws (bow_similarity_matrix, vlad_descriptors)."""
    return lambda n, k, gen: _choice(jax.random.PRNGKey(seed), n, k)


def replay_chain(seed):
    """`_draw_init` as build_vocab_tree draws: the key split once per
    k-means call, in call order."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(n, k, gen):
        state["key"], sub = jax.random.split(state["key"])
        return _choice(sub, n, k)
    return draw


def clustered(n=1500, dim=32, centers=12, noise=0.15, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, dim))
    x = c[rng.integers(0, centers, n)] + noise * rng.normal(size=(n, dim))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def borderline(x, cents):
    """Descriptors whose two nearest reference centroids tie within
    BORDER (float64 distances)."""
    d2 = ((x[:, None, :].astype(np.float64) - cents[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) <= BORDER * max(d2.max(), 1.0)


def assignments(x, cents):
    d2 = -2.0 * x.astype(np.float64) @ cents.T.astype(np.float64) \
        + (cents.astype(np.float64) ** 2).sum(-1)
    return np.argmin(d2, axis=1)


@pytest.mark.parametrize("k,iters", [(8, 20), (32, 5)])
def test_kmeans_fit_with_replayed_init(k, iters, monkeypatch):
    x = clustered()
    ref = np.asarray(j_rt.kmeans_fit(jnp.asarray(x), jax.random.PRNGKey(3),
                                     k, iters))
    monkeypatch.setattr(t_rt, "_draw_init", replay_key(3))
    got = t_rt.kmeans_fit(torch.as_tensor(x), t_rt.generator(3), k,
                          iters).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    flag = borderline(x, ref.astype(np.float64))
    diff = assignments(x, got) != assignments(x, ref)
    print(f"k={k}: flagged {int(flag.sum())} of {len(x)}, differing "
          f"{int(diff.sum())}")
    assert not (diff & ~flag).any()


def test_kmeans_init_comes_from_the_generator():
    """Without the replay the draw is the seeded generator's: the same
    seed gives the same centroids, another seed others."""
    x = torch.as_tensor(clustered(n=400))
    a = t_rt.kmeans_fit(x, t_rt.generator(1), 8, 3)
    b = t_rt.kmeans_fit(x, t_rt.generator(1), 8, 3)
    c = t_rt.kmeans_fit(x, t_rt.generator(2), 8, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bow_histograms_equal():
    descs, masks = _ring_descriptors()
    ids = sorted(descs)
    desc = np.stack([descs[i] for i in ids])
    mask = np.stack([masks[i] for i in ids])
    mask[:, ::7] = False
    cents = np.asarray(j_rt.kmeans_fit(
        jnp.asarray(desc.reshape(-1, desc.shape[-1])),
        jax.random.PRNGKey(0), 48, 10))
    ref = np.asarray(j_rt.bow_histograms(jnp.asarray(desc), jnp.asarray(mask),
                                         jnp.asarray(cents), 48))
    got = t_rt.bow_histograms(torch.as_tensor(desc),
                              torch.as_tensor(mask).float(),
                              torch.as_tensor(cents), 48).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == mask.sum()


def test_bow_histograms_chunks_give_the_same_rows(monkeypatch):
    """The image chunks that bound the (B, K, k) distances at full width
    change no row."""
    descs, masks = _ring_descriptors(n_images=10)
    desc = torch.as_tensor(np.stack([descs[i] for i in sorted(descs)]))
    mask = torch.ones(desc.shape[:2])
    cents = desc[0, :16].clone()
    whole = t_rt.bow_histograms(desc, mask, cents, 16)
    monkeypatch.setattr(t_rt, "_CHUNK_ELEMS", desc.shape[1] * 16 * 3)
    assert torch.equal(t_rt.bow_histograms(desc, mask, cents, 16), whole)


@pytest.fixture
def replayed(monkeypatch):
    monkeypatch.setattr(t_rt, "_draw_init", replay_key(0))


def test_bow_similarity_matrix(replayed):
    descs, masks = _ring_descriptors()
    opts = j_rt.RetrievalOptions(vocab_size=64)
    ids_r, ref = j_rt.bow_similarity_matrix(descs, masks, opts, seed=0)
    ids, got = t_rt.bow_similarity_matrix(
        descs, masks, interop.retrieval_options(opts._asdict()), seed=0,
        device="cpu")
    assert ids == ids_r
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("nn", [3, 50])
def test_similarity_pairs_equal(replayed, nn):
    descs, masks = _ring_descriptors()
    opts = j_rt.RetrievalOptions(vocab_size=64, num_neighbors=nn)
    ref = j_rt.similarity_pairs(descs, masks, opts, seed=0)
    got = t_rt.similarity_pairs(descs, masks,
                                interop.retrieval_options(opts._asdict()),
                                seed=0, device="cpu")
    assert [p[:2] for p in got] == [p[:2] for p in ref]
    np.testing.assert_allclose([p[2] for p in got], [p[2] for p in ref],
                               rtol=1e-5)


@pytest.mark.parametrize("overlap,period,num", [(2, 4, 3), (3, 5, 6),
                                                (2, 0, 3)])
def test_sequential_pairs_equal(replayed, overlap, period, num):
    descs, masks = _ring_descriptors()
    ids = sorted(descs)
    kw = dict(overlap=overlap, loop_detection_period=period,
              loop_detection_num_images=num, descriptors=descs, masks=masks,
              seed=0)
    ref = j_rt.sequential_pairs(
        ids, retrieval_opts=j_rt.RetrievalOptions(vocab_size=64), **kw)
    got = t_rt.sequential_pairs(
        ids, retrieval_opts=t_rt.RetrievalOptions(vocab_size=64),
        device="cpu", **kw)
    assert [p[:2] for p in got] == [p[:2] for p in ref]
    np.testing.assert_allclose([p[2] for p in got], [p[2] for p in ref],
                               rtol=1e-5)


def test_loop_detection_finds_ring_closure():
    """Twin of tests/test_loop_closure.py's test, the port's own draws."""
    descs, masks = _ring_descriptors()
    ids = sorted(descs)
    plain = t_rt.sequential_pairs(ids, overlap=2)
    with_loops = t_rt.sequential_pairs(
        ids, overlap=2, loop_detection_period=4,
        loop_detection_num_images=3, descriptors=descs, masks=masks,
        retrieval_opts=t_rt.RetrievalOptions(vocab_size=64), seed=0,
        device="cpu")
    plain_set = {(i, j) for (i, j, _) in plain}
    loop_edges = [(i, j) for (i, j, _) in with_loops
                  if (i, j) not in plain_set]
    assert loop_edges, "no loop edges proposed"
    closure = [e for e in loop_edges if e[0] <= 2 and e[1] >= len(ids) - 1]
    assert closure, f"ring closure missed: {loop_edges}"


def test_spatial_transitive_exhaustive_and_file_pairs(tmp_path):
    rng = np.random.default_rng(5)
    ids = [3, 1, 7, 4, 9, 12, 2]
    loc = rng.uniform(0, 10, (len(ids), 3))
    for kw in (dict(), dict(max_num_neighbors=2, max_distance=6.0),
               dict(max_num_neighbors=3, max_distance=1e9)):
        assert t_rt.spatial_pairs(ids, loc, **kw) == \
            j_rt.spatial_pairs(ids, loc, **kw)
    matched = [(1, 2, 0.5), (2, 3), (4, 3), (7, 9), (9, 12), (1, 12)]
    for kw in (dict(), dict(num_iterations=1, batch_size=2),
               dict(num_iterations=5, batch_size=1000)):
        assert t_rt.transitive_pairs(matched, **kw) == \
            j_rt.transitive_pairs(matched, **kw)
    assert t_rt.exhaustive_pairs(ids, block_size=2) == \
        j_rt.exhaustive_pairs(ids, block_size=2)
    path = tmp_path / "pairs.txt"
    path.write_text("# comment\na.jpg b.jpg\nc.jpg a.jpg 0.5\nb.jpg b.jpg\n"
                    "x.jpg a.jpg\nlonely\n  # indented\nc.jpg b.jpg\n")
    names = {"a.jpg": 5, "b.jpg": 2, "c.jpg": 9}
    assert t_rt.pairs_from_file(str(path), names) == \
        j_rt.pairs_from_file(str(path), names) == [(2, 5, 0.0), (5, 9, 0.0),
                                                   (2, 9, 0.0)]


def test_similarity_pairs_degenerate_inputs():
    one = {1: np.ones((4, 8), np.float32)}
    assert t_rt.similarity_pairs(one, {1: np.ones(4, bool)},
                                 device="cpu") == []
    ids, sim = t_rt.bow_similarity_matrix(one, {1: np.ones(4, bool)},
                                          device="cpu")
    assert ids == [1] and sim.shape == (1, 1)
