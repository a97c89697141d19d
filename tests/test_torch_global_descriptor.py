"""Port global descriptors (features/global_descriptor.py) vs the JAX
reference on the same images and descriptors.

The Gabor embedding goes through `sift.resize_linear` (the reference's
`jax.image.resize` "linear", antialiased when it shrinks) and `F.conv2d`
(the reference's XLA convolution): held to rel 1e-5, mixed sizes too.
VLAD, with the reference's k-means draw replayed: its signed square
root has an unbounded slope at 0, so the signed square of the
descriptor (the normalised residual sums) is held to atol 1e-7 in every
element, and the descriptor to atol 1e-6 where it exceeds 1e-2 (the
root's slope is under 50 there).
Similarity pairs on the same descriptors are the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.features import global_descriptor as j_gd
from dagsfm_tpu.features import retrieval as j_rt
from dagsfm_tpu.features import sift as j_sift
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu_torch.features import global_descriptor as t_gd
from dagsfm_tpu_torch.features import retrieval as t_rt
from tests.test_global_descriptor import _texture_crops
from tests.test_torch_retrieval import replay_key

torch.set_num_threads(1)

REL = 1e-5


@pytest.fixture(scope="module")
def ring():
    spec = j_syn.SyntheticSceneSpec(
        num_cameras=8, num_points=20, image_width=160, image_height=120,
        focal=180.0, seed=3, ring_radius=9.0, point_cloud_extent=3.5)
    return j_syn.render_images(j_syn.generate(spec))


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=REL,
                               atol=REL * np.abs(ref).max())


def _vlad_close(got, ref):
    np.testing.assert_allclose(np.sign(got) * got ** 2,
                               np.sign(ref) * ref ** 2, rtol=0, atol=1e-7)
    big = np.abs(ref) > 1e-2
    np.testing.assert_allclose(got[big], ref[big], rtol=0, atol=1e-6)


def test_gabor_bank_is_the_reference_s():
    np.testing.assert_array_equal(t_gd._BANK, j_gd._BANK)
    assert t_gd.DESC_DIM == j_gd.DESC_DIM == 384


@pytest.mark.parametrize("shape", [(120, 160), (192, 256), (100, 100),
                                   (128, 128)])
def test_embed_batch(shape):
    rng = np.random.default_rng(sum(shape))
    imgs = rng.random((3,) + shape).astype(np.float32)
    ref = np.asarray(j_gd.embed_batch(jnp.asarray(imgs)))
    got = t_gd.embed_batch(torch.as_tensor(imgs)).numpy()
    assert got.dtype == np.float32
    _close(got, ref)


def test_global_descriptors_ring_and_mixed_sizes(ring):
    rng = np.random.default_rng(0)
    mixed = {1: rng.random((120, 160)).astype(np.float32),
             2: rng.random((90, 130)).astype(np.float32),
             3: rng.random((120, 160)).astype(np.float32)}
    for images, bs in ((ring, 16), (ring, 3), (mixed, 16)):
        ref = j_gd.global_descriptors(images, batch_size=bs)
        got = t_gd.global_descriptors(images, batch_size=bs, device="cpu")
        assert got.keys() == ref.keys()
        for i in ref:
            assert got[i].shape == (t_gd.DESC_DIM,)
            _close(got[i], ref[i])


@pytest.fixture(scope="module")
def crop_features():
    """The JAX package's SIFT on sliding texture crops (descriptors in
    float32, as the port's pipeline keeps them)."""
    crops = _texture_crops()
    ids = sorted(crops)
    f = j_sift.extract(jnp.asarray(np.stack([crops[i] for i in ids])),
                       j_sift.SiftOptions(max_num_features=512,
                                          candidates_per_octave=256))
    descs = {i: np.asarray(f.descriptor[k], np.float32)
             for k, i in enumerate(ids)}
    masks = {i: np.asarray(f.mask[k]) for k, i in enumerate(ids)}
    return descs, masks


@pytest.mark.parametrize("k,cap", [(8, 20000), (16, 600)])
def test_vlad_descriptors_with_replayed_init(crop_features, k, cap,
                                             monkeypatch):
    descs, masks = crop_features
    ref = j_gd.vlad_descriptors(descs, masks, k=k, seed=1, train_cap=cap)
    monkeypatch.setattr(t_rt, "_draw_init", replay_key(1))
    got = t_gd.vlad_descriptors(descs, masks, k=k, seed=1, train_cap=cap,
                                device="cpu")
    assert got.keys() == ref.keys()
    for i in ref:
        assert got[i].shape == (k * 128,) and got[i].dtype == np.float32
        _vlad_close(got[i], ref[i])
    pg, pr = (j_gd.global_similarity_pairs(v, 2) for v in (got, ref))
    assert [p[:2] for p in pg] == [p[:2] for p in pr]
    np.testing.assert_allclose([p[2] for p in pg], [p[2] for p in pr],
                               rtol=REL, atol=1e-6)


def test_vlad_ignores_masked_slots():
    """A masked slot holding NaN (SIFT may leave one there) changes
    nothing."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=(50, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    m = np.ones(50, bool)
    m[40:] = False
    cents = torch.as_tensor(d[:8])
    a = t_gd._vlad_one(torch.as_tensor(d), torch.as_tensor(m), cents, 8)
    d[40:] = np.nan
    b = t_gd._vlad_one(torch.as_tensor(d), torch.as_tensor(m), cents, 8)
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.mark.parametrize("nn,min_score", [(2, 0.0), (4, 0.5), (20, -1.0)])
def test_global_similarity_pairs_equal(crop_features, nn, min_score):
    descs, masks = crop_features
    v = j_gd.vlad_descriptors(descs, masks, k=8, seed=0)
    assert t_gd.global_similarity_pairs(v, nn, min_score) == \
        j_gd.global_similarity_pairs(v, nn, min_score)
    assert t_gd.global_similarity_pairs({1: v[1]}) == []


def test_pair_selection_precision_vs_covisibility(monkeypatch):
    """Small twin of tests/test_global_descriptor.py's precision test
    (12 cameras of 320 x 240): on the JAX package's SIFT output and its
    images, the port's Gabor, VLAD and BoW pairs, with the k-means draws
    replayed, give the reference's precisions."""
    spec = j_syn.SyntheticSceneSpec(
        num_cameras=12, num_points=400, image_width=320, image_height=240,
        focal=343.0, seed=4, ring_radius=9.0, point_cloud_extent=3.5,
        ring_height_jitter=0.3)
    sc = j_syn.generate(spec)
    V = np.asarray(sc.visible)
    cov = V.astype(int) @ V.astype(int).T
    np.fill_diagonal(cov, -1)
    images = j_syn.render_images(sc)
    ids = sorted(images)
    id2k = {im: k for k, im in enumerate(ids)}
    K_NN = 3
    gt = {i: set(ids[b] for b in np.argsort(-cov[id2k[i]])[:K_NN])
          for i in ids}

    def precision(sel_pairs):
        nb = {i: set() for i in ids}
        for (i, j, *_r) in sel_pairs:
            nb[i].add(j)
            nb[j].add(i)
        return float(np.mean([len(nb[i] & gt[i]) / max(len(nb[i]), 1)
                              for i in ids]))

    f = j_sift.extract(jnp.asarray(np.stack([images[i] for i in ids])),
                       j_sift.SiftOptions(max_num_features=256,
                                          candidates_per_octave=256,
                                          num_octaves=3))
    descs = {i: np.asarray(f.descriptor[k], np.float32)
             for k, i in enumerate(ids)}
    masks = {i: np.asarray(f.mask[k]) for k, i in enumerate(ids)}
    monkeypatch.setattr(t_rt, "_draw_init", replay_key(0))
    ropts = j_rt.RetrievalOptions(num_neighbors=K_NN)
    ref = (precision(j_gd.global_similarity_pairs(
               j_gd.global_descriptors(images), num_neighbors=K_NN)),
           precision(j_gd.global_similarity_pairs(
               j_gd.vlad_descriptors(descs, masks, seed=0),
               num_neighbors=K_NN)),
           precision(j_rt.similarity_pairs(descs, masks, ropts, seed=0)))
    got = (precision(t_gd.global_similarity_pairs(
               t_gd.global_descriptors(images, device="cpu"),
               num_neighbors=K_NN)),
           precision(t_gd.global_similarity_pairs(
               t_gd.vlad_descriptors(descs, masks, seed=0, device="cpu"),
               num_neighbors=K_NN)),
           precision(t_rt.similarity_pairs(
               descs, masks, t_rt.RetrievalOptions(num_neighbors=K_NN),
               seed=0, device="cpu")))
    print("precision gabor, vlad, bow: port", got, "reference", ref)
    assert got == ref
    assert got[1] > 1.0 / 11 and got[2] > 1.0 / 11
