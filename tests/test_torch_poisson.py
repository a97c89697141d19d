"""The port's Poisson surface reconstruction against the JAX package on the
CPU: the trilinear splat and sample, the spectral solve (chi, iso level
and smoothed density to rel 1e-9), marching tetrahedra and the whole
poisson_mesh (the same triangles) on tests/test_mvs.py's noisy oriented
sphere. The port's splat sums each cell's contributions in a fixed order
(sorted by cell, segment sums), so it repeats bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.mvs import poisson as j_po
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.mvs import poisson as t_po

torch.set_num_threads(1)

T = (lambda a: torch.as_tensor(np.array(a, np.float64)))


def sphere(n, seed=0, noise=0.005):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v + rng.normal(0, noise, (n, 3)), v


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(1e-300, np.abs(ref).max()))


def grid_points(n, G, seed, crowd=0):
    """n points in grid coordinates of a G^3 grid, `crowd` of them in one
    cell (more than a segment chunk), some on the last cell's far faces."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, G - 1, (n, 3))
    pts[:crowd] = 3.0 + rng.uniform(0, 1, (crowd, 3))
    pts[-5:, 0] = G - 1
    return pts


@pytest.mark.parametrize("G,C,crowd", [(16, 3, 0), (8, 1, 600), (12, 4, 300)])
def test_trilinear_scatter(G, C, crowd):
    pts = grid_points(2000, G, G, crowd)
    vals = np.random.default_rng(1).normal(size=(2000, C))
    want = j_po._trilinear_scatter((G, G, G, C), jnp.asarray(pts),
                                   jnp.asarray(vals))
    got = t_po._trilinear_scatter((G, G, G, C), T(pts), T(vals))
    assert rel_err(got.numpy(), want) <= 1e-12
    again = t_po._trilinear_scatter((G, G, G, C), T(pts), T(vals))
    assert torch.equal(got, again)


def test_trilinear_sample():
    G = 10
    vol = np.random.default_rng(2).normal(size=(G, G, G))
    pts = grid_points(500, G, 3)
    want = j_po._trilinear_sample(jnp.asarray(vol), jnp.asarray(pts))
    got = t_po._trilinear_sample(T(vol), T(pts))
    assert rel_err(got.numpy(), want) <= 1e-12


def _grid_cloud(n, G, seed=0):
    xyz, nrm = sphere(n, seed)
    opts = j_po.PoissonOptions(grid=G)
    lo, hi = xyz.min(0), xyz.max(0)
    span = float((hi - lo).max())
    pad = opts.padding * span
    return (xyz - (lo - pad)) / ((span + 2 * pad) / (G - 1)), nrm


@pytest.mark.parametrize("G,screen,sigma", [(32, 4.0, 1.0), (48, 1.0, 1.5),
                                            (40, 4.0, 0.5)])
def test_poisson_field(G, screen, sigma):
    pts, nrm = _grid_cloud(4000, G)
    jchi, jiso, jdens = j_po._poisson_field(
        jnp.asarray(pts), jnp.asarray(nrm), G, jnp.asarray(screen),
        jnp.asarray(sigma))
    chi, iso, dens = t_po._poisson_field(T(pts), T(nrm), G, screen, sigma)
    assert rel_err(chi.numpy(), jchi) <= 1e-9
    assert rel_err(dens.numpy(), jdens) <= 1e-9
    assert abs(float(iso) - float(jiso)) <= 1e-9 * abs(float(jiso))


def test_pure_poisson_divides_by_zero_in_both():
    """screen = 0 ("pure Poisson") leaves the DC term's denominator 0:
    0 / 0 makes chi NaN everywhere, in the reference as here."""
    G = 16
    pts, nrm = _grid_cloud(500, G)
    jchi, jiso, _ = j_po._poisson_field(jnp.asarray(pts), jnp.asarray(nrm),
                                        G, jnp.asarray(0.0), jnp.asarray(1.0))
    chi, iso, _ = t_po._poisson_field(T(pts), T(nrm), G, 0.0, 1.0)
    assert np.isnan(np.asarray(jchi)).all() and np.isnan(float(jiso))
    assert torch.isnan(chi).all() and torch.isnan(iso)


def test_marching_tets_is_the_reference():
    G = 24
    pts, nrm = _grid_cloud(3000, G, 1)
    chi, iso, dens = j_po._poisson_field(jnp.asarray(pts), jnp.asarray(nrm),
                                         G, jnp.asarray(4.0),
                                         jnp.asarray(1.0))
    chi, dens = np.asarray(chi), np.asarray(dens)
    mask = dens > 0.05 * dens.mean()
    for m in (mask, np.ones_like(mask), np.zeros_like(mask)):
        jv, jt = j_po._marching_tets(chi, float(iso), m)
        tv, tt = t_po._marching_tets(chi, float(iso), m)
        assert np.array_equal(tv, jv) and np.array_equal(tt, jt)


@pytest.mark.parametrize("G,n", [(48, 4000), (64, 8000)])
def test_poisson_mesh_same_triangles(G, n):
    xyz, nrm = sphere(n)
    opts = j_po.PoissonOptions(grid=G)
    jv, jt = j_po.poisson_mesh(xyz, nrm, opts)
    tv, tt = t_po.poisson_mesh(xyz, nrm, interop.poisson_options(
        opts._asdict()), device="cpu")
    assert np.array_equal(tt, jt)
    assert rel_err(tv, jv) <= 1e-9
    r = np.linalg.norm(tv - xyz.mean(0), axis=1)
    assert len(tt) > 2000 and abs(r.mean() - 1.0) < 0.02


def test_poisson_mesh_repeats_bit_for_bit():
    xyz, nrm = sphere(3000, 4)
    a = t_po.poisson_mesh(xyz, nrm, t_po.PoissonOptions(grid=32),
                          device="cpu")
    b = t_po.poisson_mesh(xyz, nrm, t_po.PoissonOptions(grid=32),
                          device="cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_poisson_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    xyz, nrm = sphere(100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_po.poisson_mesh(xyz, nrm)
