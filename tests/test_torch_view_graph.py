"""The view graph and the native graph core of the port against the JAX
package: largest component, subgraph, maximum spanning tree, triplets
and the rotation-cycle filter are identical on the same edges; the
port's ctypes bindings of the committed libgraphcore.so and their
pure-Python paths give the reference's results."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagsfm_tpu.graph import native as j_ng
from dagsfm_tpu.graph import view_graph as j_vg
from dagsfm_tpu.ops import rotations as j_rops
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.graph import native as t_ng
from dagsfm_tpu_torch.graph import view_graph as t_vg

torch.set_num_threads(1)


def _graphs(n=16, seed=0, edge_prob=0.5, noise_deg=2.0, bad=3):
    """The same random view graph in both packages: noisy relative
    rotations, a few corrupted, and a small second component."""
    rng = np.random.default_rng(seed)
    R = np.asarray(j_rops.angleaxis_to_rotmat(
        jnp.asarray(rng.normal(0, 0.8, (n, 3)))))
    jg = j_vg.ViewGraph()
    for i in range(n):
        for j in range(i + 1, n):
            if j != i + 1 and rng.random() > edge_prob:
                continue
            Rn = np.asarray(j_rops.angleaxis_to_rotmat(jnp.asarray(
                rng.normal(0, np.radians(noise_deg), 3))))
            a, b = (i, j) if rng.random() < 0.5 else (j, i)   # both ways
            jg.add_edge(j_vg.TwoViewEdge(a, b, Rn @ R[b] @ R[a].T,
                                         rng.normal(size=3),
                                         int(rng.integers(16, 200))))
    for k in rng.choice(len(jg.edges), bad, replace=False):
        key = list(jg.edges)[k]
        jg.edges[key].rotation = np.asarray(j_rops.angleaxis_to_rotmat(
            jnp.asarray(rng.normal(0, 1.0, 3))))
    jg.add_edge(j_vg.TwoViewEdge(n + 5, n + 6, np.eye(3), np.ones(3), 30))
    return jg, interop.view_graph(jg)


def _same(jg, tg):
    assert jg.nodes == tg.nodes
    assert list(jg.edges) == list(tg.edges)
    for k, e in jg.edges.items():
        f = tg.edges[k]
        np.testing.assert_array_equal(e.rotation, f.rotation)
        np.testing.assert_array_equal(e.position, f.position)
        assert (e.image_id1, e.image_id2, e.num_inliers) == \
            (f.image_id1, f.image_id2, f.num_inliers)


@pytest.mark.parametrize("seed", [0, 1])
def test_components_tree_and_triplets_are_the_reference(seed):
    jg, tg = _graphs(seed=seed)
    _same(jg, tg)
    # edges added the other way round are stored inverted, the same way
    e = j_vg.TwoViewEdge(9, 4, np.diag([1.0, -1.0, -1.0]),
                         np.array([1.0, 2.0, 3.0]), 7)
    jg.add_edge(e)
    tg.add_edge(t_vg.TwoViewEdge(9, 4, e.rotation, e.position, 7))
    _same(jg, tg)
    cc = jg.largest_connected_component()
    assert cc == tg.largest_connected_component() and len(cc) == 16
    _same(jg.subgraph(cc), tg.subgraph(cc))
    assert jg.maximum_spanning_tree() == tg.maximum_spanning_tree()
    assert jg.triplets() == tg.triplets()
    assert sorted(jg.neighbors(4)) == sorted(tg.neighbors(4))


@pytest.mark.parametrize("max_deg", [5.0, 2.0])
def test_cycle_filter_drops_the_reference_edges(max_deg):
    jg, tg = _graphs(seed=2, noise_deg=0.5)
    removed = jg.filter_cycles_by_rotation(max_deg)
    assert tg.filter_cycles_by_rotation(max_deg, device="cpu") == removed
    assert removed >= 4          # the corrupted edges and the lone pair
    _same(jg, tg)


def test_cycle_filter_without_triplets_drops_every_edge():
    g = t_vg.ViewGraph()
    g.add_edge(t_vg.TwoViewEdge(0, 1, np.eye(3), np.zeros(3), 10))
    assert g.filter_cycles_by_rotation(device="cpu") == 1
    assert g.num_edges() == 0


def test_union_find():
    uf = t_vg.UnionFind(6)
    for a, b in [(0, 1), (2, 3), (1, 3)]:
        uf.union(a, b)
    assert len({uf.find(v) for v in range(4)}) == 1
    assert uf.find(4) != uf.find(5) != uf.find(0)


@pytest.fixture(scope="module")
def native_graph():
    """tests/test_native_graph.py's graph: two components."""
    rng = np.random.default_rng(0)
    edges = []
    for _ in range(2000):
        i, j = rng.integers(0, 300, 2)
        if i != j:
            edges.append((min(i, j), max(i, j)))
    edges += [(v, v + 1) for v in range(300, 499)]
    edges = np.array(sorted(set(edges)), np.int64)
    return 500, edges, rng.uniform(1, 100, len(edges))


@pytest.fixture(params=["library", "python"])
def lib_mode(request, monkeypatch):
    """Both packages through the shared library, or both through their
    pure-Python paths."""
    assert t_ng.available() and j_ng.available()
    if request.param == "python":
        for mod in (t_ng, j_ng):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    return request.param


def test_native_core_is_the_reference(native_graph, lib_mode):
    n, edges, w = native_graph
    np.testing.assert_array_equal(t_ng.connected_components(n, edges),
                                  j_ng.connected_components(n, edges))
    np.testing.assert_array_equal(t_ng.largest_cc_mask(n, edges),
                                  j_ng.largest_cc_mask(n, edges))
    for maximize in (True, False):
        np.testing.assert_array_equal(
            t_ng.kruskal(n, edges, w, maximize=maximize),
            j_ng.kruskal(n, edges, w, maximize=maximize))
    np.testing.assert_array_equal(t_ng.triangles(n, edges),
                                  j_ng.triangles(n, edges))
    sub = edges[edges[:, 1] < 120]
    np.testing.assert_array_equal(t_ng.cnm_communities(120, sub, w[:len(sub)]),
                                  j_ng.cnm_communities(120, sub, w[:len(sub)]))


def test_native_ncut_is_the_reference(native_graph):
    n, edges, w = native_graph
    sub = edges[edges[:, 1] < 200]
    for parts, seed in ((2, 1), (4, 2)):
        labels = t_ng.ncut(200, sub, w[:len(sub)], parts, seed=seed,
                           device="cpu")
        np.testing.assert_array_equal(
            labels, j_ng.ncut(200, sub, w[:len(sub)], parts, seed=seed))
        assert len(np.unique(labels)) == parts
