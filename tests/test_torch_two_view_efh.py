"""Port F7 / F8 / H solvers, E/F/H verification and guided matching vs
the JAX reference.

Solvers and residuals are compared on the same inputs. The batched
RANSACs (`_efh_batched`) get the reference's own E, F and H sample
indices (drawn from its kE, kF, kH split of each pair's key), so models,
inlier sets and poses must agree exactly. `classify_pairs` draws its
samples from a torch.Generator, so it is held on planted pairs whose
inlier sets do not hinge on the samples: the same configs and inlier
masks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.features import matching as j_fm
from dagsfm_tpu.ops import epipolar as j_epi
from dagsfm_tpu.ops import ransac as j_rnsc
from dagsfm_tpu.ops import two_view_classify as j_tvc
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.features import matching as t_fm
from dagsfm_tpu_torch.ops import epipolar as t_epi
from dagsfm_tpu_torch.ops import two_view_classify as t_tvc

torch.set_num_threads(1)

F_PX, CX, CY = 800.0, 512.0, 384.0
K = np.array([[F_PX, 0, CX], [0, F_PX, CY], [0, 0, 1.0]])
SIZE = (1024, 768)


def _rot(rng, scale):
    ang = rng.normal(size=3) * scale
    th = np.linalg.norm(ang)
    Kx = np.array([[0, -ang[2], ang[1]], [ang[2], 0, -ang[0]],
                   [-ang[1], ang[0], 0]]) / th
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def pixel_pair(seed, n=80, kind="general", outlier_frac=0.25, noise_px=0.05):
    """Pixel correspondences of two cameras K [I|0], K [R|t]: a 3D cloud
    ("general"), a plane ("planar") or a pure rotation ("panoramic"),
    with outliers at random pixels."""
    rng = np.random.default_rng(seed)
    if kind == "planar":
        X = np.c_[rng.uniform(-2, 2, (n, 2)), np.full(n, 8.0)]
    else:
        X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 8]
    R = _rot(rng, 0.1)
    t = np.zeros(3) if kind == "panoramic" else \
        np.array([1.0, 0.2, 0.1]) + rng.normal(size=3) * 0.1
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    p1 = x1 * F_PX + [CX, CY] + rng.normal(size=(n, 2)) * noise_px
    p2 = x2 * F_PX + [CX, CY] + rng.normal(size=(n, 2)) * noise_px
    bad = rng.random(n) < outlier_frac
    p2[bad] = rng.uniform([0, 0], SIZE, (bad.sum(), 2))
    return p1, p2, bad


def canon(M):
    M = np.asarray(M) / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


J = jnp.asarray
T = torch.as_tensor


def test_fundamental_and_homography_solvers_match():
    p1, p2, _ = pixel_pair(1, n=40, outlier_frac=0.0)
    m = np.ones(40, bool)
    m[-5:] = False
    for mask in (None, m):
        jF = j_epi.fundamental_8pt(J(p1), J(p2), None if mask is None
                                   else J(mask))[0][0]
        tF = t_epi.fundamental_8pt(T(p1), T(p2), None if mask is None
                                   else T(mask))[0][0]
        np.testing.assert_allclose(canon(tF.numpy()), canon(jF), rtol=1e-7,
                                   atol=1e-10)
    jF7, jv = j_epi.fundamental_7pt(J(p1[:7]), J(p2[:7]))
    tF7, tv = t_epi.fundamental_7pt(T(p1[:7]), T(p2[:7]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for a, b in zip(tF7.numpy()[tv.numpy()], np.asarray(jF7)[np.asarray(jv)]):
        np.testing.assert_allclose(canon(a), canon(b), rtol=1e-6, atol=1e-9)
    # a batch of 7-point samples broadcasts
    tb = t_epi.fundamental_7pt(T(np.stack([p1[:7], p1[7:14]])),
                               T(np.stack([p2[:7], p2[7:14]])))[0]
    np.testing.assert_allclose(tb[0].numpy(), tF7.numpy(), rtol=1e-12,
                               atol=1e-15)

    hp1, hp2, _ = pixel_pair(2, n=30, kind="planar", outlier_frac=0.0)
    for sl, mask in ((slice(0, 4), None), (slice(None), np.ones(30, bool))):
        jH = j_epi.homography_dlt(J(hp1[sl]), J(hp2[sl]), None if mask is None
                                  else J(mask))[0][0]
        tH = t_epi.homography_dlt(T(hp1[sl]), T(hp2[sl]), None if mask is None
                                  else T(mask))[0][0]
        np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-7,
                                   atol=1e-9)
    jH = np.asarray(jH)
    np.testing.assert_allclose(
        t_epi.homography_error(T(jH), T(hp1), T(hp2)).numpy(),
        np.asarray(j_epi.homography_error(J(jH), J(hp1), J(hp2))),
        rtol=1e-9, atol=1e-12)
    jF = np.asarray(jF)
    for name in ("sampson_error", "epipolar_line_error"):
        np.testing.assert_allclose(
            getattr(t_epi, name)(T(jF), T(p1), T(p2)).numpy(),
            np.asarray(getattr(j_epi, name)(J(jF), J(p1), J(p2))),
            rtol=1e-9, atol=1e-15)
    Kt = T(K)
    np.testing.assert_allclose(
        t_epi.essential_from_fundamental(T(jF), Kt, Kt).numpy(),
        np.asarray(j_epi.essential_from_fundamental(J(jF), J(K), J(K))),
        rtol=1e-12)
    np.testing.assert_allclose(
        t_epi.fundamental_from_essential(T(jF), Kt, Kt).numpy(),
        np.asarray(j_epi.fundamental_from_essential(J(jF), J(K), J(K))),
        rtol=1e-9)


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_efh_batched_with_reference_samples(kind):
    H = 48
    pairs = [pixel_pair(10 + s, n=70, kind=kind) for s in range(2)]
    N = 72
    B = len(pairs)
    p1b, p2b = np.zeros((B, N, 2)), np.zeros((B, N, 2))
    mb = np.zeros((B, N), bool)
    for k, (p1, p2, _) in enumerate(pairs):
        p1b[k, :70], p2b[k, :70], mb[k, :70] = p1, p2, True
    x1b = (p1b - [CX, CY]) / F_PX
    x2b = (p2b - [CX, CY]) / F_PX
    thr_n = np.full(B, (4.0 / F_PX) ** 2)
    thr_p = np.full(B, 16.0)
    Kb = np.stack([K] * B)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    samples = {"E": [], "F": [], "H": []}
    for k in range(B):
        kE, kF, kH = jax.random.split(keys[k], 3)
        for name, key, s in (("E", kE, 5), ("F", kF, 7), ("H", kH, 4)):
            samples[name].append(np.asarray(j_rnsc._sample_indices(
                key, H, s, N, J(mb[k]))))
    ref = jax.device_get(j_tvc._efh_batched(
        keys, J(x1b), J(x2b), J(p1b), J(p2b), J(mb), J(thr_n), J(thr_p),
        J(Kb), J(Kb), H))
    port = interop.to_numpy(t_tvc._efh_batched(
        T(x1b), T(x2b), T(p1b), T(p2b), T(mb), T(thr_n), T(thr_p), T(Kb),
        T(Kb), {k: T(np.stack(v)) for k, v in samples.items()}))
    for k in range(B):
        for m_i, n_i, inl_i in ((0, 1, 2), (6, 7, 8), (9, 10, 11)):
            np.testing.assert_allclose(canon(port[m_i][k]),
                                       canon(ref[m_i][k]), rtol=1e-6,
                                       atol=1e-9)
            assert int(port[n_i][k]) == int(ref[n_i][k])
            np.testing.assert_array_equal(port[inl_i][k], ref[inl_i][k])
        for r_i in (3, 12):                                  # R, R_F
            np.testing.assert_allclose(port[r_i][k], ref[r_i][k], atol=1e-6)
        for t_i in (4, 13):                                  # t, t_F
            np.testing.assert_allclose(np.abs(port[t_i][k]),
                                       np.abs(ref[t_i][k]), atol=1e-6)
        assert int(port[5][k]) == int(ref[5][k])
        assert port[10][k] > 0.9 * (~pairs[k][2]).sum() or kind == "general"


def _rows():
    rows = []
    for s, kind in enumerate(["general", "planar", "panoramic", "general"]):
        p1, p2, _ = pixel_pair(20 + s, n=60 + 10 * s, kind=kind,
                               noise_px=0.0 if kind == "panoramic" else 0.05)
        rows.append(((s, s + 1), p1, p2, K, K, SIZE, SIZE, s != 3))
    # a watermark: the same border pixels in both images
    rng = np.random.default_rng(5)
    wm = np.c_[rng.uniform(0, 80, 40), rng.uniform(0, 768, 40)]
    rows.append(((7, 8), wm, wm + [0.3, -0.2], K, K, SIZE, SIZE, True))
    p1, p2, _ = pixel_pair(30, n=12)                        # too few
    rows.append(((9, 10), p1, p2, K, K, SIZE, SIZE, True))
    return rows


def test_classify_pairs_full_efh_configs_and_inliers():
    rows = _rows()
    jopts = j_tvc.TwoViewOptions(num_hypotheses=128)
    topts = interop.two_view_options(dataclasses.asdict(jopts))
    jres = j_tvc.classify_pairs(rows, jopts, seed=0)
    tres = t_tvc.classify_pairs(rows, topts, seed=0, device="cpu")
    assert jres.keys() == tres.keys()
    configs = {pk: jres[pk].config for pk in jres}
    assert configs == {(0, 1): j_tvc.CALIBRATED, (1, 2): j_tvc.PLANAR,
                       (2, 3): j_tvc.PANORAMIC, (3, 4): j_tvc.UNCALIBRATED,
                       (7, 8): j_tvc.WATERMARK, (9, 10): j_tvc.DEGENERATE}
    for pk in jres:
        assert tres[pk].config == jres[pk].config, pk
        assert tres[pk].num_inliers == jres[pk].num_inliers, pk
        np.testing.assert_array_equal(tres[pk].inlier_mask,
                                      jres[pk].inlier_mask)
        for name in ("E", "F", "H"):
            assert (getattr(tres[pk], name) is None) == \
                (getattr(jres[pk], name) is None), (pk, name)
        if jres[pk].R is not None:
            cos = (np.trace(tres[pk].R.T @ jres[pk].R) - 1) / 2
            assert np.degrees(np.arccos(min(cos, 1.0))) < 1.0, pk
    one = t_tvc.classify_two_view(rows[0][1], rows[0][2], K, K, SIZE, SIZE,
                                  topts, device="cpu")
    assert one.config == t_tvc.CALIBRATED


def test_pose_from_homography_matches():
    p1, p2, bad = pixel_pair(3, n=50, kind="planar", outlier_frac=0.0)
    H = np.asarray(j_epi.homography_dlt(J(p1), J(p2))[0][0])
    Hn = np.linalg.inv(K) @ H @ K
    x1 = (p1 - [CX, CY]) / F_PX
    x2 = (p2 - [CX, CY]) / F_PX
    Rj, tj, nj = j_tvc.pose_from_homography(Hn, x1, x2)
    Rt, tt, nt = t_tvc.pose_from_homography(Hn, x1, x2)
    np.testing.assert_allclose(Rt, Rj, atol=1e-12)
    np.testing.assert_allclose(tt, tj, atol=1e-12)
    assert nt == nj == 50


def _guided_inputs(seed, use_h):
    """A pair with planted matches on top of 3D or planar geometry, and
    distractors with similar descriptors that the geometry rules out."""
    rng = np.random.default_rng(seed)
    Kp = 192
    p1, p2, _ = pixel_pair(seed, n=Kp, kind="planar" if use_h else "general",
                           outlier_frac=0.0)
    d1 = np.abs(rng.normal(size=(Kp, 128)))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = np.clip(d1 + rng.normal(0, 0.05, d1.shape), 0, None)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    perm = rng.permutation(Kp)
    d2, p2 = d2[perm], p2[perm]
    m1 = rng.random(Kp) > 0.1
    m2 = rng.random(Kp) > 0.1
    if use_h:
        G = np.asarray(j_epi.homography_dlt(J(p1), J(p2[np.argsort(perm)]))
                       [0][0])
    else:
        G = np.asarray(j_epi.fundamental_8pt(J(p1), J(p2[np.argsort(perm)]))
                       [0][0])
    return (d1.astype(np.float32), d2.astype(np.float32), p1, p2, m1, m2, G)


@pytest.mark.parametrize("use_h", [False, True])
def test_guided_match_pair_matches(use_h):
    d1, d2, p1, p2, m1, m2, G = _guided_inputs(40 + use_h, use_h)
    opts = j_fm.MatchingOptions()
    jm, jn = j_fm.guided_match_pair(J(d1), J(d2), J(p1), J(p2), J(m1), J(m2),
                                    J(G, jnp.float32), max_error_px=4.0,
                                    opts=opts, use_homography=use_h)
    tm, tn = t_fm.guided_match_pair(T(d1), T(d2), T(p1), T(p2), T(m1), T(m2),
                                    T(G), max_error_px=4.0,
                                    use_homography=use_h)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tn) == int(jn) > 50
