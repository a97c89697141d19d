"""ops/linalg.py and ops/ransac_variants.py of the port against the JAX
package's on the CPU, in float64, inputs from numpy seeds.

- linalg: gauss_jordan, rq_decomposition, decompose_projection_matrix,
  matrix_square_root and levenberg_marquardt (the same residuals written
  in each package) to rel 1e-9; QR's signs are fixed by both packages,
  so R and Q are compared, not only their product.
- ransac_variants: the host functions (prosac_prefix_sizes,
  evsac_weights, exhaustive_sample_indices, sprt_decision_threshold)
  exactly; sprt_test's log ratio to rel 1e-12 and the same decision;
  robust_estimate with each sampler and both scorings, driven by the JAX
  package's own sample indices, gives the same inlier mask and count and
  the model to rel 1e-12 (the line solver's products may fuse on
  XLA:CPU), the final score to rel 1e-6 (see the test). The samplers'
  own draws: PROSAC's stay in each hypothesis' prefix, and weighted
  draws of one entry fall within 3 sigma of their expected frequencies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.ops import linalg as j_la
from dagsfm_tpu.ops import ransac as j_ransac
from dagsfm_tpu.ops import ransac_variants as j_rv
from dagsfm_tpu.ops import rotations as j_rops
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.ops import linalg as t_la
from dagsfm_tpu_torch.ops import ransac_variants as t_rv
from dagsfm_tpu_torch.ops import rotations as t_rops

torch.set_num_threads(1)

RTOL = 1e-9


def close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= rtol * scale, np.abs(got - ref).max()


# ------------------------------------------------------------- linalg

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gauss_jordan(seed):
    rng = np.random.default_rng(seed)
    n = 4 + seed
    A = rng.normal(0, 1, (n, n)) + n * np.eye(n)
    B = rng.normal(0, 1, (n, 2))
    for b in (None, B):
        jr, jx = j_la.gauss_jordan(jnp.asarray(A),
                                   None if b is None else jnp.asarray(b))
        tr, tx = t_la.gauss_jordan(torch.as_tensor(A),
                                   None if b is None else torch.as_tensor(b))
        close(tr, jr)
        close(tx, jx)


def test_gauss_jordan_pivots():
    """A zero leading pivot forces a row swap."""
    A = np.array([[0.0, 2.0, 1.0], [3.0, 1.0, 0.0], [1.0, 0.0, 4.0]])
    _, jx = j_la.gauss_jordan(jnp.asarray(A))
    _, tx = t_la.gauss_jordan(torch.as_tensor(A))
    close(tx, jx)
    close(tx.numpy() @ A, np.eye(3), rtol=1e-12)


@pytest.mark.parametrize("seed", [2, 3])
def test_rq_and_projection(seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(0, 1, (3, 3))
    jR, jQ = j_la.rq_decomposition(jnp.asarray(M))
    tR, tQ = t_la.rq_decomposition(torch.as_tensor(M))
    close(tR, jR)
    close(tQ, jQ)
    K = np.array([[500.0, 0, 320], [0, 480, 240], [0, 0, 1]])
    R = t_rops.angleaxis_to_rotmat(
        torch.as_tensor(rng.normal(0, 0.5, 3))).numpy()
    P = K @ np.hstack([R, rng.normal(0, 1, 3)[:, None]])
    for got, ref in zip(t_la.decompose_projection_matrix(torch.as_tensor(P)),
                        j_la.decompose_projection_matrix(jnp.asarray(P))):
        close(got, ref)


def test_matrix_square_root():
    rng = np.random.default_rng(4)
    B = rng.normal(0, 1, (3, 4, 4))
    A = B @ B.transpose(0, 2, 1) + 4 * np.eye(4)
    for a in (A[0], A):                       # one matrix, and a batch
        close(t_la.matrix_square_root(torch.as_tensor(a)),
              j_la.matrix_square_root(jnp.asarray(a)))


def _rosen(np_):
    def r(x):
        return np_.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])
    return r


def test_levenberg_marquardt_rosenbrock():
    jo = j_la.levenberg_marquardt(_rosen(jnp), jnp.asarray([-1.2, 1.0]),
                                  max_iterations=100)
    to = t_la.levenberg_marquardt(_rosen(torch),
                                  torch.tensor([-1.2, 1.0], dtype=torch.float64),
                                  max_iterations=100)
    for got, ref in zip(to, jo):
        close(got, ref)


def test_levenberg_marquardt_pose_polish():
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, (30, 3))
    aa, t = np.array([0.1, -0.2, 0.15]), np.array([0.3, 0.1, -0.2])
    Y = t_rops.angleaxis_to_rotmat(torch.as_tensor(aa)).numpy() @ X.T
    Y = Y.T + t

    def j_res(p):
        q = j_rops.angleaxis_to_quat(p[:3])
        pred = j_rops.quat_rotate(jnp.broadcast_to(q, (30, 4)),
                                  jnp.asarray(X)) + p[3:]
        return (pred - jnp.asarray(Y)).ravel()

    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)

    def t_res(p):
        q = t_rops.angleaxis_to_quat(p[:3])
        pred = t_rops.quat_rotate(q.expand(30, 4), Xt) + p[3:]
        return (pred - Yt).reshape(-1)

    jo = j_la.levenberg_marquardt(j_res, jnp.zeros(6), max_iterations=40)
    to = t_la.levenberg_marquardt(t_res, torch.zeros(6, dtype=torch.float64),
                                  max_iterations=40)
    close(to.x, jo.x)
    close(to.initial_cost, jo.initial_cost)
    close(to.lam, jo.lam)
    assert float(to.final_cost) < 1e-16


# ------------------------------------------------------ ransac variants

def j_line_solver(xs, ys):
    a, b = ys[1] - ys[0], xs[0] - xs[1]
    c = -(a * xs[0] + b * ys[0])
    n = jnp.sqrt(a * a + b * b)
    ok = n > 1e-9
    n = jnp.maximum(n, 1e-9)
    return jnp.stack([a / n, b / n, c / n])[None], ok[None]


def t_line_solver(xs, ys):
    a, b = ys[1] - ys[0], xs[0] - xs[1]
    c = -(a * xs[0] + b * ys[0])
    n = torch.sqrt(a * a + b * b)
    ok = n > 1e-9
    n = torch.clamp(n, min=1e-9)
    return torch.stack([a / n, b / n, c / n])[None], ok[None]


def line_residual(model, xs, ys):
    return (model[0] * xs + model[1] * ys + model[2]) ** 2


def _refit(np_, where, sqrt):
    """Weighted total least squares on the inliers (the line's normal is
    the small eigenvector of the 2 x 2 scatter, in closed form)."""
    def refit(xs, ys, inl):
        w = where(inl, 1.0, 0.0)
        sw = np_.sum(w) + 1e-12
        mx, my = np_.sum(w * xs) / sw, np_.sum(w * ys) / sw
        sxx = np_.sum(w * (xs - mx) ** 2)
        syy = np_.sum(w * (ys - my) ** 2)
        sxy = np_.sum(w * (xs - mx) * (ys - my))
        lam = 0.5 * (sxx + syy) - sqrt(0.25 * (sxx - syy) ** 2 + sxy ** 2)
        a, b = sxy, lam - sxx
        n = sqrt(a * a + b * b) + 1e-300
        a, b = a / n, b / n
        return np_.stack([a, b, -(a * mx + b * my)])
    return refit


def line_data(seed, n=100, outlier_frac=0.25, noise=0.01):
    """y = 2x + 1 with a share of outliers; quality correlated with
    inlier-ness (a ratio-test score's role)."""
    rng = np.random.default_rng(seed)
    n_out = int(n * outlier_frac)
    x = rng.uniform(-5, 5, n)
    y = 2 * x + 1 + rng.normal(0, noise, n)
    out = rng.choice(n, n_out, replace=False)
    y[out] += rng.uniform(2, 10, n_out) * rng.choice([-1, 1], n_out)
    is_inl = np.ones(n, bool)
    is_inl[out] = False
    quality = is_inl * 1.0 + rng.uniform(0, 0.3, n)
    mask = np.ones(n, bool)
    mask[rng.choice(n, 5, replace=False)] = False      # a few masked out
    return x, y, is_inl, quality, mask


def reference_indices(sampler, key, H, S, mask, quality):
    """The (H, S) samples the JAX package's robust_estimate draws."""
    n = len(mask)
    m, q = jnp.asarray(mask), jnp.asarray(quality)
    if sampler == "uniform":
        return np.asarray(j_ransac._sample_indices(key, H, S, n, m))
    if sampler == "prosac":
        return np.asarray(j_rv.prosac_sample_indices(key, H, S, n, m, q))
    return np.asarray(j_rv.weighted_sample_indices(key, H, S, n, m, q))


@pytest.mark.parametrize("sampler,scoring,refit,seed", [
    ("uniform", "msac", False, 0), ("uniform", "lmeds", False, 1),
    ("prosac", "msac", True, 2), ("prosac", "lmeds", False, 3),
    ("weighted", "msac", False, 4), ("weighted", "lmeds", True, 5),
    ("exhaustive", "msac", True, 6), ("exhaustive", "lmeds", False, 7)])
def test_robust_estimate_replays_reference(sampler, scoring, refit, seed):
    n = 16 if sampler == "exhaustive" else 100
    x, y, is_inl, quality, mask = line_data(seed, n=n)
    H, thr = 128, 0.01
    key = jax.random.PRNGKey(seed)
    kw = dict(sample_size=2, threshold=thr if scoring == "msac" else 0.0,
              num_hypotheses=H, sampler=sampler, scoring=scoring)
    jres = j_rv.robust_estimate(
        key, j_line_solver, line_residual, (jnp.asarray(x), jnp.asarray(y)),
        jnp.asarray(mask), quality=jnp.asarray(quality),
        refit=_refit(jnp, jnp.where, jnp.sqrt) if refit else None, **kw)
    idx = None if sampler == "exhaustive" else reference_indices(
        sampler, key, H, 2, mask, quality)
    tres = t_rv.robust_estimate(
        t_line_solver, line_residual, (torch.as_tensor(x),
                                       torch.as_tensor(y)),
        torch.as_tensor(mask), quality=torch.as_tensor(quality),
        refit=_refit(torch, torch.where, torch.sqrt) if refit else None,
        sample_idx=None if idx is None else torch.as_tensor(idx), **kw)
    close(tres.model, jres.model, rtol=1e-12)
    assert np.array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.num_inliers) == int(jres.num_inliers)
    assert bool(tres.valid) == bool(jres.valid)
    # the score to rel 1e-6: LMedS's threshold is a median of squared
    # residuals near 1e-4, each the difference of terms near 10, so the
    # models' last-bit differences move it (measured: rel 5.7e-8)
    close(tres.score, jres.score, rtol=1e-6)
    # and the planted line is found
    assert tres.inliers.numpy()[is_inl & mask].mean() > 0.9


def test_prosac_prefix_and_exhaustive_and_evsac_are_the_reference_s():
    for n, m, H in ((100, 2, 500), (40, 3, 64), (7, 2, 10)):
        assert np.array_equal(t_rv.prosac_prefix_sizes(n, m, H),
                              j_rv.prosac_prefix_sizes(n, m, H))
    for n, m in ((6, 2), (9, 3)):
        assert np.array_equal(t_rv.exhaustive_sample_indices(n, m),
                              j_rv.exhaustive_sample_indices(n, m))
    rng = np.random.default_rng(2)
    d = np.sort(rng.uniform(0.1, 1.0, (100, 3)), axis=1)
    for k in (2, 3):
        assert np.array_equal(t_rv.evsac_weights(d, k),
                              j_rv.evsac_weights(d, k))


@pytest.mark.parametrize("opts", [j_rv.SPRTOptions(),
                                  j_rv.SPRTOptions(delta=0.01, epsilon=0.5),
                                  j_rv.SPRTOptions(eval_time_ratio=50.0,
                                                   num_models_per_sample=2.0)])
def test_sprt(opts):
    topts = interop.sprt_options(opts)
    assert t_rv.sprt_decision_threshold(topts) == \
        j_rv.sprt_decision_threshold(opts)
    x, y, *_ , mask = line_data(5, outlier_frac=0.2)
    for model in ([2.0 / 5 ** 0.5, -1.0 / 5 ** 0.5, 1.0 / 5 ** 0.5],
                  [1.0, 0.0, 3.0]):
        r = line_residual(np.asarray(model), x, y)
        ja, jl = j_rv.sprt_test(jnp.asarray(r), jnp.asarray(mask), 0.01, opts)
        ta, tl = t_rv.sprt_test(torch.as_tensor(r), torch.as_tensor(mask),
                                0.01, topts)
        assert bool(ta) == bool(ja)
        close(tl, jl, rtol=1e-12)


def test_prosac_draws_stay_in_the_prefix():
    n, H, S = 60, 400, 3
    rng = np.random.default_rng(8)
    quality = torch.as_tensor(rng.random(n))
    mask = torch.ones(n, dtype=torch.bool)
    mask[[3, 17]] = False
    gen = torch.Generator().manual_seed(8)
    idx = t_rv.prosac_sample_indices(gen, H, S, n, mask, quality).numpy()
    order = np.argsort(-np.where(mask.numpy(), quality.numpy(), -np.inf),
                       kind="stable")
    rank = np.empty(n, int)
    rank[order] = np.arange(n)
    sizes = t_rv.prosac_prefix_sizes(n, S, H)
    assert (rank[idx] < sizes[:, None]).all()
    assert all(len(set(r)) == S for r in idx)            # distinct
    # the masked entries sort last: prefixes within the valid ones draw
    # only valid entries (longer ones reach them, as the JAX package's do)
    short = sizes <= int(mask.sum())
    assert short.sum() > H // 2 and mask.numpy()[idx[short]].all()


def test_weighted_draws_follow_the_weights():
    """One draw per hypothesis: counts within 3 sigma of H p."""
    n, H = 12, 20000
    rng = np.random.default_rng(9)
    w = rng.uniform(0.1, 1.0, n)
    mask = np.ones(n, bool)
    mask[4] = False
    gen = torch.Generator().manual_seed(9)
    idx = t_rv.weighted_sample_indices(
        gen, H, 1, n, torch.as_tensor(mask), torch.as_tensor(w)).numpy()
    counts = np.bincount(idx[:, 0], minlength=n)
    p = np.where(mask, w, 0.0) / np.where(mask, w, 0.0).sum()
    sigma = np.sqrt(H * p * (1 - p))
    assert counts[4] == 0
    assert (np.abs(counts - H * p) <= 3 * sigma + 1e-9).all(), \
        (counts, H * p, sigma)


def test_robust_estimate_draws_from_a_generator():
    x, y, is_inl, quality, mask = line_data(10)
    args = (t_line_solver, line_residual,
            (torch.as_tensor(x), torch.as_tensor(y)), torch.as_tensor(mask))
    for sampler in ("uniform", "prosac", "weighted"):
        res = [t_rv.robust_estimate(
            *args, sample_size=2, threshold=0.01, num_hypotheses=64,
            sampler=sampler, quality=torch.as_tensor(quality),
            generator=torch.Generator().manual_seed(3)) for _ in range(2)]
        assert torch.equal(res[0].model, res[1].model)   # seeded: repeats
        assert res[0].inliers.numpy()[is_inl & mask].mean() > 0.9
    with pytest.raises(ValueError):
        t_rv.robust_estimate(*args, sample_size=2, threshold=0.01)
