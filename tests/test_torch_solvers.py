"""The port's solvers and the last helpers against the JAX package's on
the CPU, inputs from numpy seeds:

- solvers/admm.py: l1_regression, constrained_l1 and box_qp in float64
  to rel 1e-9 (l1_regression's primal and dual residuals, about 1e-14
  at convergence, to an absolute 1e-12), on planted problems;
- solvers/sdp.py and estimation/lagrange_dual.py: Y of solve_block_sdp
  to 1e-8, the rotations to 1e-6 degrees and the rank-3 certificate to
  1e-8 (eigh's eigenvector signs differ between libraries; Y, the
  rotations and the certificate do not see them);
  estimate_rotations_nonlinear to 1e-6 degrees (angles from the skew
  part: arccos of the trace cannot resolve 1e-6 degrees);
- clustering/scene_clustering.py: the same tree leaves, the spectral
  start node replayed from the JAX package's draw;
- graph/svg.py: the files byte for byte;
- utils/observability.py: the same records and rendered text.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.clustering import scene_clustering as j_sc
from dagsfm_tpu.estimation import lagrange_dual as j_ld
from dagsfm_tpu.graph import svg as j_svg
from dagsfm_tpu.graph.view_graph import TwoViewEdge, ViewGraph
from dagsfm_tpu.solvers import admm as j_admm
from dagsfm_tpu.solvers import sdp as j_sdp
from dagsfm_tpu.utils import observability as j_obs
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.clustering import scene_clustering as t_sc
from dagsfm_tpu_torch.estimation import lagrange_dual as t_ld
from dagsfm_tpu_torch.graph import svg as t_svg
from dagsfm_tpu_torch.solvers import admm as t_admm
from dagsfm_tpu_torch.solvers import sdp as t_sdp
from dagsfm_tpu_torch.utils import observability as t_obs
from tests.test_rotation_averaging import angular_errors, make_ra_problem
from tests.test_torch_clustering import reference_starts  # noqa: F401

torch.set_num_threads(1)


def close(got, ref, rtol=1e-9, atol=0.0):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-300) + atol, err


def T(a):
    return torch.as_tensor(np.asarray(a))


def angle_deg(Ra, Rb) -> np.ndarray:
    """Angles of Ra_k^T Rb_k in degrees from atan2 of the skew part and
    the trace, which resolves small angles (arccos of the trace alone
    bottoms out near 1.2e-6 degrees in float64)."""
    M = np.einsum("nji,njk->nik", np.asarray(Ra), np.asarray(Rb))
    v = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                  M[:, 1, 0] - M[:, 0, 1]], axis=1) / 2
    c = (np.trace(M, axis1=1, axis2=2) - 1) / 2
    return np.degrees(np.arctan2(np.linalg.norm(v, axis=1), c))


# ---------------------------------------------------------------- ADMM

def l1_problem(seed, N=20, M=200):
    rng = np.random.default_rng(seed)
    x_true = rng.normal(0, 1, N)
    A = rng.normal(0, 1, (M, N))
    b = A @ x_true
    out = rng.random(M) < 0.2
    b[out] += rng.uniform(5, 10, out.sum()) * rng.choice([-1, 1], out.sum())
    return x_true, A, b


@pytest.mark.parametrize("alpha,iters", [(1.0, 300), (1.5, 200)])
def test_l1_regression(alpha, iters):
    x_true, A, b = l1_problem(0)
    jo = j_admm.ADMMOptions(alpha=alpha, max_iterations=iters)
    to = interop.admm_options(jo)
    ref = j_admm.l1_regression(jnp.asarray(A), jnp.asarray(b), jo)
    got = t_admm.l1_regression(T(A), T(b), to)
    close(got[0], ref[0])
    # the primal and dual residuals are near 1e-14 at convergence, pure
    # rounding: held to an absolute 1e-12
    for g, r in zip(got[1:], ref[1:]):
        close(g, r, rtol=0.0, atol=1e-12)
    assert np.abs(got[0].numpy() - x_true).max() < 1e-2


@pytest.mark.parametrize("active", [0, 3])
def test_constrained_l1(active):
    """x >= 0.5 inactive (the planted x is recovered), or three
    constraints above the planted x (parity only)."""
    rng = np.random.default_rng(1)
    N, M = 10, 100
    x_true = np.abs(rng.normal(0, 1, N)) + 0.5
    A = rng.normal(0, 1, (M, N))
    b = A @ x_true
    C = np.eye(N)
    d = np.full(N, 0.5)
    d[:active] = x_true[:active] + 0.2
    opts = j_admm.ADMMOptions(max_iterations=300)
    ref = j_admm.constrained_l1(*(jnp.asarray(a) for a in (A, b, C, d)),
                                opts)
    got = t_admm.constrained_l1(*(T(a) for a in (A, b, C, d)),
                                interop.admm_options(opts))
    close(got, ref)
    if not active:
        assert np.abs(got.numpy() - x_true).max() < 1e-2
        assert (got.numpy() >= 0.5 - 1e-6).all()


@pytest.mark.parametrize("rho", [1.0, 4.0])
def test_box_qp(rho):
    rng = np.random.default_rng(2)
    N = 15
    Q = rng.normal(0, 1, (N, N))
    P = Q.T @ Q + np.eye(N)
    x_unc = rng.normal(0, 2, N)
    q = -P @ x_unc
    lb, ub = np.full(N, -1.0), np.full(N, 1.0)
    opts = j_admm.ADMMOptions(rho=rho, max_iterations=400)
    ref = j_admm.box_qp(*(jnp.asarray(a) for a in (P, q, lb, ub)), opts)
    got = t_admm.box_qp(*(T(a) for a in (P, q, lb, ub)),
                        interop.admm_options(opts)).numpy()
    close(got, ref)
    assert (got >= lb).all() and (got <= ub).all()
    inside = (got > lb + 1e-3) & (got < ub - 1e-3)
    assert np.abs((P @ got + q)[inside]).max() < 0.05


# ----------------------------------------------------------------- SDP

@pytest.mark.parametrize("n,noise,seed,edge_prob", [
    (12, 0.0, 5, 0.6), (15, 2.0, 6, 0.5)])
def test_lagrange_dual(n, noise, seed, edge_prob):
    R_gt, edges, rels = make_ra_problem(n, noise_deg=noise, seed=seed,
                                        edge_prob=edge_prob)
    C = np.zeros((3 * n, 3 * n))
    for e, (i, j) in enumerate(edges):
        C[3 * i:3 * i + 3, 3 * j:3 * j + 3] += rels[e].T
        C[3 * j:3 * j + 3, 3 * i:3 * i + 3] += rels[e]
    jY = np.asarray(j_sdp.solve_block_sdp(jnp.asarray(C), n, sweeps=50))
    tY = t_sdp.solve_block_sdp(T(C), n, sweeps=50)
    close(tY.numpy(), jY, rtol=0.0, atol=1e-8)
    close(float(t_sdp.rank3_residual(tY)),
          float(j_sdp.rank3_residual(jnp.asarray(jY))), rtol=0.0, atol=1e-8)

    jR, jcert = j_ld.estimate_rotations_lagrange_dual(n, edges, rels)
    tR, tcert = t_ld.estimate_rotations_lagrange_dual(n, edges, rels,
                                                      device="cpu")
    assert angle_deg(tR, jR).max() < 1e-6
    assert abs(tcert - jcert) < 1e-8
    errs = angular_errors(tR, R_gt)
    assert (errs.max() < 0.1 and tcert < 1e-3) if noise == 0 else \
        errs.mean() < 1.5


def test_sdp_keeps_a_zero_column():
    """An image with no edge: S = 0, so its off-diagonal blocks stay 0
    (the scale switch), in both packages."""
    n = 4
    rng = np.random.default_rng(3)
    C = np.zeros((3 * n, 3 * n))
    R = t_sdp.project_to_rotmat(T(rng.normal(size=(3, 3, 3)))).numpy()
    for e, (i, j) in enumerate(((0, 1), (1, 2), (0, 2))):
        C[3 * i:3 * i + 3, 3 * j:3 * j + 3] = R[e].T
        C[3 * j:3 * j + 3, 3 * i:3 * i + 3] = R[e]
    jY = np.asarray(j_sdp.solve_block_sdp(jnp.asarray(C), n, sweeps=5))
    tY = t_sdp.solve_block_sdp(T(C), n, sweeps=5).numpy()
    close(tY, jY, rtol=0.0, atol=1e-8)
    assert not tY[9:, :9].any()


def test_nonlinear_rotations():
    R_gt, edges, rels = make_ra_problem(20, noise_deg=1.0, seed=7)
    jR = j_ld.estimate_rotations_nonlinear(20, edges, rels)
    tR = t_ld.estimate_rotations_nonlinear(20, edges, rels, device="cpu")
    assert angle_deg(tR, jR).max() < 1e-6
    assert angular_errors(tR, R_gt).mean() < 0.6
    init = np.einsum("nij,njk->nik", R_gt, t_sdp.project_to_rotmat(
        T(np.eye(3) + np.random.default_rng(1).normal(0, 0.02, (20, 3, 3))))
        .numpy())
    jR = j_ld.estimate_rotations_nonlinear(20, edges, rels, init=init,
                                           iterations=10)
    tR = t_ld.estimate_rotations_nonlinear(20, edges, rels, init=init,
                                           iterations=10, device="cpu")
    assert angle_deg(tR, jR).max() < 1e-6


# ------------------------------------------------------- the rest

def _blob_graph(seed, blobs=2, size=20, p=0.4):
    rng = np.random.default_rng(seed)
    pairs, weights = [], []
    for blob in range(blobs):
        off = blob * size
        for i in range(size):
            for j in range(i + 1, size):
                if rng.random() < p:
                    pairs.append((off + i, off + j))
                    weights.append(float(rng.integers(5, 20)))
    for blob in range(blobs - 1):
        pairs.append((blob * size + 5, (blob + 1) * size + 5))
        weights.append(1.0)
    return pairs, weights


def _leaves(sc):
    return sorted(tuple(sorted(leaf.image_ids)) for leaf in
                  sc.leaf_clusters())


@pytest.mark.parametrize("blobs,leaf,overlap,seed", [
    (2, 25, 3, 2), (3, 18, 2, 4), (2, 50, 3, 5)])
def test_scene_clustering_leaves(reference_starts, blobs, leaf, overlap,  # noqa: F811
                                 seed):
    pairs, weights = _blob_graph(seed, blobs)
    opts = j_sc.SceneClusteringOptions(leaf_max_num_images=leaf,
                                       image_overlap=overlap, seed=seed)
    jsc = j_sc.SceneClustering(opts)
    jsc.partition(pairs, weights)
    tsc = t_sc.SceneClustering(interop.scene_clustering_options(opts),
                               device="cpu")
    tsc.partition(pairs, weights)
    assert _leaves(tsc) == _leaves(jsc)
    assert len(_leaves(tsc)) >= (2 if blobs * 20 > leaf else 1)


@pytest.mark.parametrize("cell", [5, 9])
def test_svg_byte_for_byte(tmp_path, cell):
    rng = np.random.default_rng(cell)
    ids = [3, 7, 8, 11, 20]
    edges = {(ids[i], ids[j]): float(rng.integers(1, 200))
             for i in range(5) for j in range(i + 1, 5) if rng.random() < 0.7}
    edges[(20, 3)] = 55.5                    # the other orientation
    edges[(99, 3)] = 10.0                    # a node not in the plot
    for name, (j_fn, t_fn) in {"adj": (j_svg.write_adjacency_svg,
                                       t_svg.write_adjacency_svg)}.items():
        j_fn(ids, edges, str(tmp_path / f"j{name}.svg"), cell=cell)
        t_fn(ids, edges, str(tmp_path / f"t{name}.svg"), cell=cell)
    j_svg.write_adjacency_svg([], {}, str(tmp_path / "je.svg"))
    t_svg.write_adjacency_svg([], {}, str(tmp_path / "te.svg"))
    vg = ViewGraph()
    vg.add_edge(TwoViewEdge(1, 2, np.eye(3), np.zeros(3), 80, 1.0))
    vg.add_edge(TwoViewEdge(2, 3, np.eye(3), np.zeros(3), 40, 1.0))
    j_svg.write_view_graph_svg(vg, str(tmp_path / "jvg.svg"), cell=cell)
    t_svg.write_view_graph_svg(vg, str(tmp_path / "tvg.svg"), cell=cell)
    for name in ("adj", "e", "vg"):
        assert (tmp_path / f"t{name}.svg").read_bytes() == \
            (tmp_path / f"j{name}.svg").read_bytes()


def test_observability_records_and_render(tmp_path, monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.25))
    clock_ns = iter(range(0, 10 ** 12, 250_000_000))
    for mod in (j_obs, t_obs):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
    # the port's stages are spans, timed on perf_counter_ns
    monkeypatch.setattr(t_obs.time, "perf_counter_ns", lambda: next(clock_ns))
    out = []
    for mod in (j_obs, t_obs):
        t = mod.StageTimer()
        for name in ("a", "b", "a"):
            with t.stage(name):
                pass
        m = mod.ProgressMonitor()
        m.start(0, 10)
        m.start(1, 20)
        m.update(0, 5)
        done0 = m.all_completed()
        m.complete(0)
        m.complete(1)
        info = m.job(2)
        info.total_image_num = 4
        info.reset()
        out.append((t.records, t.report(), done0, m.all_completed(),
                    m.render(), info == mod.RunningInfo()))
    assert out[1] == out[0]
    with t_obs.profiler_trace(None):
        pass
    with t_obs.profiler_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
