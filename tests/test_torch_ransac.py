"""Port RANSAC / two-view verification vs the JAX reference.

torch cannot replay jax.random, so the reference's own sample indices
(`_sample_indices` from the same key) are fed to the port's `ransac`;
solving, scoring and the LO refit must then agree exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.ops import epipolar as j_epi
from dagsfm_tpu.ops import ransac as j_rnsc
from dagsfm_tpu.ops import two_view_classify as j_tvc
from dagsfm_tpu.sfm import incremental_mapper as j_im
from dagsfm_tpu_torch.ops import epipolar as t_epi
from dagsfm_tpu_torch.ops import ransac as t_rnsc
from dagsfm_tpu_torch.ops import two_view_classify as t_tvc

torch.set_num_threads(1)


def two_view(seed, n=96, outlier_frac=0.3, noise_px=0.5, f=800.0):
    """Normalized correspondences of a random scene seen by two cameras."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 8]
    ang = rng.normal(size=3) * 0.1
    th = np.linalg.norm(ang)
    Kx = np.array([[0, -ang[2], ang[1]], [ang[2], 0, -ang[0]],
                   [-ang[1], ang[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = np.array([1.0, 0.2, 0.1]) + rng.normal(size=3) * 0.1
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    x1 = x1 + rng.normal(size=x1.shape) * noise_px / f
    x2 = x2 + rng.normal(size=x2.shape) * noise_px / f
    bad = rng.random(n) < outlier_frac
    x2[bad] = rng.uniform(-0.4, 0.4, (bad.sum(), 2))
    return x1, x2, bad, f


def canon(E):
    E = np.asarray(E) / np.linalg.norm(E)
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_essential_ransac_with_reference_samples(seed):
    x1, x2, bad, f = two_view(seed)
    n, H = len(x1), 64
    mask = np.ones(n, bool)
    mask[-6:] = False                          # padded tail
    thr = (4.0 / f) ** 2
    key = jax.random.PRNGKey(seed)
    idx = np.asarray(j_rnsc._sample_indices(key, H, 5, n, jnp.asarray(mask)))
    ref = j_im._ransac_essential(key, jnp.asarray(x1), jnp.asarray(x2),
                                 jnp.asarray(mask), thr, H)
    T = (lambda a: torch.as_tensor(np.array(a))[None])
    res = t_tvc.ransac_essential(T(x1), T(x2), T(mask), thr, T(idx))
    np.testing.assert_allclose(canon(res.model[0].numpy()), canon(ref.model),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(res.inliers[0].numpy(),
                                  np.asarray(ref.inliers))
    assert int(res.num_inliers[0]) == int(ref.num_inliers)
    np.testing.assert_allclose(float(res.score[0]), float(ref.score),
                               rtol=1e-8)
    assert res.inliers[0].numpy()[~bad & mask].mean() > 0.95


def test_five_point_solutions_match():
    x1, x2, _, _ = two_view(5, n=5, outlier_frac=0.0, noise_px=0.0)
    Et, vt = t_epi.essential_5pt(torch.as_tensor(x1), torch.as_tensor(x2))
    Ej, vj = j_epi.essential_5pt(jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    for a, b in zip(Et.numpy()[vt.numpy()], np.asarray(Ej)[np.asarray(vj)]):
        np.testing.assert_allclose(canon(a), canon(b), rtol=1e-7, atol=1e-9)
    x1, x2, _, _ = two_view(6, n=40, outlier_frac=0.0)
    E = np.asarray(j_epi.essential_8pt(jnp.asarray(x1), jnp.asarray(x2))[0][0])
    np.testing.assert_allclose(
        canon(t_epi.essential_8pt(torch.as_tensor(x1),
                                  torch.as_tensor(x2))[0][0].numpy()),
        canon(E), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        t_epi.sampson_error(torch.as_tensor(E), torch.as_tensor(x1),
                            torch.as_tensor(x2)).numpy(),
        np.asarray(j_epi.sampson_error(jnp.asarray(E), jnp.asarray(x1),
                                       jnp.asarray(x2))), rtol=1e-9)
    m = np.ones(40, bool)
    Rt, tt, nt = t_epi.pose_from_essential(
        torch.as_tensor(E), torch.as_tensor(x1), torch.as_tensor(x2),
        torch.as_tensor(m))
    Rj, tj, nj = j_epi.pose_from_essential(jnp.asarray(E), jnp.asarray(x1),
                                           jnp.asarray(x2), jnp.asarray(m))
    assert int(nt) == int(nj) == 40
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-9)
    np.testing.assert_allclose(np.abs(tt.numpy()), np.abs(np.asarray(tj)),
                               atol=1e-9)


def test_sample_indices_are_uniform_subsets_of_valid():
    g = torch.Generator().manual_seed(0)
    mask = torch.zeros((2, 50), dtype=torch.bool)
    mask[0, :30] = True
    mask[1, 10:] = True
    idx = t_rnsc.sample_indices(g, mask, 400, 5)
    assert idx.shape == (2, 400, 5)
    for b in range(2):
        assert bool(mask[b][idx[b]].all())
        assert all(len(set(r.tolist())) == 5 for r in idx[b])
    counts = torch.bincount(idx[0].flatten(), minlength=50)[:30].float()
    assert counts.min() > 0.5 * counts.mean()


def test_classify_pairs_essential_only_inlier_counts():
    from dagsfm_tpu_torch.scene import cameras as t_cm
    cam = t_cm.make_simple_camera(1, 1024, 768, focal=800.0)
    K = cam.calibration_matrix()
    rows = []
    for s in range(4):
        # low noise: the two packages draw different samples, and the
        # inlier sets must not hinge on an outlier at the threshold
        x1, x2, bad, f = two_view(10 + s, n=60 + 20 * s, noise_px=0.05)
        p1 = x1 * f + K[:2, 2]
        p2 = x2 * f + K[:2, 2]
        rows.append(((s, s + 1), p1, p2, K, K, (1024, 768), (1024, 768),
                     True))
    rows.append(((9, 10), rows[0][1][:10], rows[0][2][:10], K, K,
                 (1024, 768), (1024, 768), True))        # too few: DEGENERATE
    jres = j_tvc.classify_pairs(rows, j_tvc.TwoViewOptions(
        essential_only=True, num_hypotheses=128), seed=0)
    tres = t_tvc.classify_pairs(rows, t_tvc.TwoViewOptions(
        essential_only=True, num_hypotheses=128), seed=0, device="cpu")
    assert jres.keys() == tres.keys()
    for pk in jres:
        assert tres[pk].config == jres[pk].config
        assert tres[pk].num_inliers == jres[pk].num_inliers
        np.testing.assert_array_equal(tres[pk].inlier_mask,
                                      jres[pk].inlier_mask)
        if jres[pk].config == j_tvc.CALIBRATED:
            # different samples: the poses agree to the noise, not exactly
            cos = (np.trace(tres[pk].R.T @ jres[pk].R) - 1) / 2
            assert np.degrees(np.arccos(min(cos, 1.0))) < 5.0
    assert tres[(9, 10)].config == t_tvc.DEGENERATE
    # without essential_only the same pair runs the full E/F/H selection
    full = t_tvc.classify_pairs(rows[:1], t_tvc.TwoViewOptions(
        num_hypotheses=128), device="cpu")
    assert full[(0, 1)].config == t_tvc.CALIBRATED
    assert full[(0, 1)].F is not None and full[(0, 1)].H is None
