"""Clustering of the port against the JAX package on
tests/test_clustering.py's planted-partition graphs.

spectral_cluster draws its first k-means centroid with jax.random in the
reference, which torch cannot replay: the tests give the port the
reference's start node (`start=`, or `_draw_start` in place of the
port's generator). With it the labels agree up to a permutation;
community detection, the native NCUT and every ImageClustering route
(SPECTRAL, COMMUNITY, HYBRID, NCUT through cut, expand, cut_and_expand,
expand_all_edges and the adaptive switch) give identical clusters."""
import jax
import numpy as np
import pytest
import torch

from dagsfm_tpu.clustering import community as j_cd
from dagsfm_tpu.clustering import image_clustering as j_ic
from dagsfm_tpu.clustering import spectral as j_sp
from dagsfm_tpu.graph import native as j_ng
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.clustering import community as t_cd
from dagsfm_tpu_torch.clustering import image_clustering as t_ic
from dagsfm_tpu_torch.clustering import spectral as t_sp
from dagsfm_tpu_torch.graph import native as t_ng
from tests.test_clustering import planted_partition

torch.set_num_threads(1)


def reference_start(num_nodes: int, seed: int) -> int:
    """The node the reference's spectral k-means starts from."""
    return int(jax.random.randint(jax.random.PRNGKey(seed), (), 0,
                                  num_nodes))


@pytest.fixture
def reference_starts(monkeypatch):
    monkeypatch.setattr(t_sp, "_draw_start", reference_start)


def _canonical(labels) -> np.ndarray:
    """Labels renumbered by first appearance (equal up to a permutation
    iff these are equal)."""
    first = {}
    return np.array([first.setdefault(int(v), len(first)) for v in labels])


@pytest.mark.parametrize("blocks,size,k,seed", [(4, 25, 4, 0), (5, 20, 3, 1),
                                                (3, 30, 2, 2)])
def test_spectral_labels_match_reference(blocks, size, k, seed):
    edges, w, gt, n = planted_partition(num_blocks=blocks, block_size=size,
                                        seed=seed)
    ref = j_sp.spectral_cluster(edges, w, n, k, seed=seed)
    labels = t_sp.spectral_cluster(edges, w, n, k, seed=seed,
                                   start=reference_start(n, seed),
                                   device="cpu")
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(_canonical(labels), _canonical(ref))
    # the port's own start: a valid k-way labelling of the same graph
    own = t_sp.spectral_cluster(edges, w, n, k, seed=seed, device="cpu")
    assert len(np.unique(own)) == k
    for kk, nn in ((1, n), (k, k - 1)):
        np.testing.assert_array_equal(
            t_sp.spectral_cluster(edges, w, nn, kk, device="cpu"),
            j_sp.spectral_cluster(edges, w, nn, kk))
    assert t_sp.normalized_cut_value(edges, w, labels) == pytest.approx(
        j_sp.normalized_cut_value(edges, w, ref), rel=1e-12)


@pytest.mark.parametrize("seed", [1, 3])
def test_community_detection_is_identical(seed):
    edges, w, _, n = planted_partition(seed=seed)
    labels = t_cd.community_detection(edges, w, n)
    np.testing.assert_array_equal(labels, j_cd.community_detection(edges, w,
                                                                   n))
    assert t_cd.modularity(edges, w, labels) == j_cd.modularity(edges, w,
                                                                labels)


def _graph(seed, n):
    edges, w, _, n = planted_partition(num_blocks=5, block_size=n // 5,
                                       seed=seed)
    return list(range(n)), {(int(i), int(j)): float(x)
                            for (i, j), x in zip(edges, w)}


def _same_clusters(jc, tc):
    assert [(c.cluster_id, c.image_ids, c.edges) for c in jc] == \
        [(c.cluster_id, c.image_ids, c.edges) for c in tc]
    assert [(c.cluster_id, c.image_ids, c.edges) for c in jc] == \
        [(c.cluster_id, c.image_ids, c.edges)
         for c in interop.image_clusters(jc)]


ROUTES = [("SPECTRAL", 60, 0), ("COMMUNITY", 60, 1), ("HYBRID", 40, 4),
          ("NCUT", 60, 2)]


@pytest.mark.parametrize("ctype,ub,seed", ROUTES)
def test_cut_and_expand_give_identical_clusters(reference_starts, ctype, ub,
                                                seed):
    nodes, edges = _graph(seed, 250)
    jc, tc = _pair(nodes, edges, num_images_ub=ub, image_overlap=20,
                   completeness_ratio=0.5, cluster_type=ctype, seed=seed)
    _same_clusters(jc.cut(), tc.cut())
    assert jc.lost_edges == tc.lost_edges
    _same_clusters(jc.expand(), tc.expand())
    assert jc.summary == tc.summary
    assert jc.adaptive_cluster_type() == tc.adaptive_cluster_type()


def _pair(nodes, edges, **kw):
    return (j_ic.ImageClustering(nodes, edges, j_ic.ClusteringOptions(**kw)),
            t_ic.ImageClustering(nodes, edges, t_ic.ClusteringOptions(**kw),
                                 device="cpu"))


@pytest.mark.parametrize("ctype,ub,seed", ROUTES)
def test_expand_all_edges_is_identical(reference_starts, ctype, ub, seed):
    nodes, edges = _graph(seed + 7, 150)
    jc, tc = _pair(nodes, edges, num_images_ub=ub, cluster_type=ctype,
                   seed=seed)
    _same_clusters(jc.expand_all_edges(), tc.expand_all_edges())


# bicut takes branching_factor labels, which COMMUNITY and HYBRID do not
# bound (the reference raises IndexError there too)
@pytest.mark.parametrize("ctype,ub,seed", [r for r in ROUTES
                                           if r[0] in ("SPECTRAL", "NCUT")])
def test_cut_and_expand_iterative_is_identical(reference_starts, ctype, ub,
                                               seed):
    nodes, edges = _graph(seed + 7, 150)
    jc, tc = _pair(nodes, edges, num_images_ub=ub, cluster_type=ctype,
                   seed=seed)
    _same_clusters(jc.cut_and_expand(), tc.cut_and_expand())
    assert jc.summary == tc.summary


def test_ncut_without_the_library_falls_back_to_spectral(reference_starts,
                                                         monkeypatch):
    for mod in (t_ng, j_ng):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)
    jc, tc = _pair(*_graph(5, 100), num_images_ub=40, cluster_type="NCUT",
                   seed=3)
    _same_clusters(jc.cut(), tc.cut())


def test_adaptive_switch_follows_degree_spread():
    """A star (one hub) has a large degree spread: HYBRID; a ring none."""
    star = {(0, j): 10.0 for j in range(1, 60)}
    ring = {(j, (j + 1) % 60): 10.0 for j in range(60)}
    for edges, want in ((star, "HYBRID"), (ring, "SPECTRAL")):
        tc = t_ic.ImageClustering(list(range(60)), edges, device="cpu")
        jc = j_ic.ImageClustering(list(range(60)), edges)
        assert tc.adaptive_cluster_type() == jc.adaptive_cluster_type() \
            == want
