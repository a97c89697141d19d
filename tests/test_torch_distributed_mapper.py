"""The port's DistributedMapperController end to end on the CPU, on
tests/test_pipeline.py's fixture (24 cameras, 5 % outlier matches, seed
17, clusters of at most 10), through both view-graph branches and held
to that test's limits; the partitions' export and resume, the cluster
jobs, report(), the options carried from the JAX package, and the
parallel-layer options that raise. Stage-by-stage parity with the JAX
package is in tests/test_torch_distributed_stages.py.

The match-graph branch classifies every pair with E/F/H RANSAC; here it
draws 32 hypotheses per model (about 13 s on one CPU thread), its slow
twin the fixture's 256."""
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from dagsfm_tpu.clustering import image_clustering as j_ic
from dagsfm_tpu.pipeline import distributed_mapper as j_dm
from dagsfm_tpu.sfm import incremental_mapper as j_im
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.clustering.image_clustering import ClusteringOptions
from dagsfm_tpu_torch.ops import rotations as t_rops
from dagsfm_tpu_torch.ops import two_view_classify as t_tvc
from dagsfm_tpu_torch.pipeline import distributed_mapper as t_dm
from dagsfm_tpu_torch.scene import synthetic as t_syn
from dagsfm_tpu_torch.sfm.incremental_mapper import MapperOptions

torch.set_num_threads(1)


def pipeline_problem(mod):
    """test_pipeline.py's scene and matching problem, built by `mod`
    (either package's synthetic module)."""
    sc = mod.generate(mod.SyntheticSceneSpec(
        num_cameras=24, num_points=600, pixel_noise=0.3, seed=17))
    return sc, mod.to_matching_problem(sc, match_outlier_fraction=0.05,
                                       seed=2)


def noisy_geometries(sc, graph, seed: int = 0) -> dict:
    """Two-view geometries as a matching stage reports them: each pair's
    true relative pose with 0.3 deg of rotation noise, three pairs with
    wrong rotations, as many inliers as matches, CALIBRATED."""
    rng = np.random.default_rng(seed)
    pairs = list(graph.image_pairs())
    bad = set(rng.choice(len(pairs), 3, replace=False).tolist())
    out = {}
    for n, (i, j) in enumerate(pairs):
        Rij = sc.R[j - 1] @ sc.R[i - 1].T
        aa = rng.normal(0, 1.0 if n in bad else np.radians(0.3), 3)
        t = sc.t[j - 1] - Rij @ sc.t[i - 1]
        out[(i, j)] = (t_rops.angleaxis_to_rotmat(torch.as_tensor(aa))
                       .numpy() @ Rij, t / np.linalg.norm(t),
                       len(graph.matches_between(i, j)), t_tvc.CALIBRATED)
    return out


def pipeline_options(hypotheses: int = 256, **kw):
    """test_pipeline.py's options in the port."""
    return t_dm.DistributedMapperOptions(
        clustering=ClusteringOptions(num_images_ub=10, image_overlap=6,
                                     completeness_ratio=0.5),
        mapper=MapperOptions(init_min_num_inliers=30,
                             num_ransac_hypotheses=hypotheses, seed=11),
        final_ba_iterations=25, seed=5, **kw)


@pytest.fixture(scope="module")
def problem():
    return pipeline_problem(t_syn)


def _run(problem, branch, hypotheses):
    """(controller, merged model, the local models as mapped: the merge
    folds the others into the anchor's). The match-graph branch goes
    through run()."""
    sc, (cams, images, graph) = problem
    geo = noisy_geometries(sc, graph) if branch == "two_view" else None
    ctrl = t_dm.DistributedMapperController(
        cams, images, graph, pipeline_options(hypotheses),
        two_view_geometries=geo, device="cpu")
    if geo is None:
        return ctrl, ctrl.run(), None
    ctrl.build_view_graph()
    ctrl.filter_and_average_rotations()
    ctrl.cluster_scenes()
    local = copy.deepcopy(ctrl.reconstruct_partitions())
    merged = ctrl.merge_clusters()
    ctrl.adjust_global_bundle(merged)
    ctrl.timings["total"] = sum(ctrl.timings.values())
    return ctrl, merged, local


def _check_limits(sc, ctrl, merged):
    """tests/test_pipeline.py's limits."""
    assert ctrl.view_graph.num_edges() > 20
    assert len(ctrl.clusters) >= 2 and len(ctrl.local_recons) >= 2
    assert merged.num_reg_images() >= 22, merged.num_reg_images()
    assert len(ctrl.separators) >= 2
    errs = t_syn.pose_errors(merged, sc)
    assert errs["ate"] < 0.05 and errs["rot_err_deg_mean"] < 0.3, errs
    assert ctrl.separator_rmse(merged) < 2.0
    assert "total" in ctrl.timings
    assert ctrl.report().startswith("Timings:")
    e = ctrl.view_graph_edges
    assert e["built"] >= e["cycles"] >= e["component"] >= \
        e["orientation"] >= e["final"] == ctrl.view_graph.num_edges()
    for c in ctrl.clusters:
        assert c.image_ids == sorted(c.image_ids)
    assert ctrl.ba_stats.final_cost <= ctrl.ba_stats.initial_cost


@pytest.fixture(scope="module")
def two_view_run(problem):
    return _run(problem, "two_view", 256)


def test_two_view_branch_within_pipeline_limits(problem, two_view_run):
    ctrl, merged, local = two_view_run
    _check_limits(problem[0], ctrl, merged)
    # the three wrong rotations never reach the clustering
    assert ctrl.view_graph_edges["built"] - ctrl.view_graph.num_edges() >= 3
    sizes = [len(c.image_ids) for c in ctrl.clusters]
    assert [len(r.images) for r in local] == sorted(sizes, reverse=True)
    assert [{im.cluster_id for im in r.images.values()} for r in local] == \
        [{c.cluster_id} for c in sorted(ctrl.clusters,
                                        key=lambda c: -len(c.image_ids))]


def test_match_graph_branch_within_pipeline_limits(problem):
    _check_limits(problem[0], *_run(problem, "match_graph", 32)[:2])


@pytest.mark.slow
def test_match_graph_branch_at_full_size(problem):
    _check_limits(problem[0], *_run(problem, "match_graph", 256)[:2])


def test_partitions_resume_and_jobs(problem, two_view_run, tmp_path):
    """export_partitions -> partitions_exist -> run(checkpoint_path) skips
    to the merge and gives the first run's model to the bit."""
    sc, (cams, images, graph) = problem
    ctrl, merged, local = two_view_run
    assert not t_dm.DistributedMapperController.partitions_exist(tmp_path)
    ctrl.local_recons = copy.deepcopy(local)
    ctrl.export_partitions(str(tmp_path))
    assert t_dm.DistributedMapperController.partitions_exist(str(tmp_path))
    again = t_dm.DistributedMapperController(
        cams, images, graph, pipeline_options(), device="cpu")
    back = again.load_partitions(str(tmp_path))
    assert len(back) == len(local)
    for a, b in zip(local, back):
        assert a.reg_image_ids == b.reg_image_ids
        for i in a.reg_image_ids:
            np.testing.assert_array_equal(a.images[i].qvec, b.images[i].qvec)
    resumed = t_dm.DistributedMapperController(
        cams, images, graph, pipeline_options(), device="cpu").run(
            checkpoint_path=str(tmp_path))
    assert resumed.reg_image_ids == merged.reg_image_ids
    for i in merged.reg_image_ids:
        np.testing.assert_array_equal(resumed.images[i].tvec,
                                      merged.images[i].tvec)
    ctrl.export_cluster_jobs(str(tmp_path / "jobs"))
    jobs = json.loads((tmp_path / "jobs" / "clusters.json").read_text())
    assert jobs == [{"cluster_id": c.cluster_id, "image_ids": c.image_ids}
                    for c in ctrl.clusters]
    lines = ctrl.report().splitlines()
    assert lines[0] == "Timings:" and len(lines) == len(ctrl.timings) + 1
    for stage in ("view_graph", "rotation_averaging", "clustering",
                  "reconstruction", "merge", "final_ba", "total"):
        assert any(line.strip().startswith(stage + ":") for line in lines)


def test_retriangulation_keeps_the_limits(problem, two_view_run):
    sc, (cams, images, graph) = problem
    ctrl = t_dm.DistributedMapperController(
        cams, images, graph, pipeline_options(retriangulate=True),
        two_view_geometries=noisy_geometries(sc, graph), device="cpu")
    ctrl.local_recons = copy.deepcopy(two_view_run[2])
    merged = ctrl.merge_clusters()
    ctrl.retriangulate(merged)
    ctrl.adjust_global_bundle(merged)
    assert "retriangulation" in ctrl.timings
    assert merged.num_reg_images() >= 22
    errs = t_syn.pose_errors(merged, sc)
    assert errs["ate"] < 0.05, errs
    assert ctrl.separator_rmse(merged) < 2.0


def test_parallel_layer_options_raise(problem):
    _, (cams, images, graph) = problem
    ctrl = t_dm.DistributedMapperController(
        cams, images, graph, pipeline_options(distributed_final_ba=True),
        device="cpu")
    with pytest.raises(NotImplementedError, match="parallel/distributed"):
        ctrl.reconstruct_partitions(num_threads=2)
    with pytest.raises(NotImplementedError, match="parallel/ba_sharded"):
        ctrl.adjust_global_bundle(None)


def test_options_carry_over_from_the_reference():
    ref = j_dm.DistributedMapperOptions(
        clustering=j_ic.ClusteringOptions(num_images_ub=10, image_overlap=6,
                                          completeness_ratio=0.5),
        mapper=j_im.MapperOptions(init_min_num_inliers=30,
                                  num_ransac_hypotheses=256, seed=11),
        final_ba_iterations=25, seed=5)
    opts = interop.distributed_mapper_options(dataclasses.asdict(ref))
    assert opts == pipeline_options()
    assert interop.distributed_mapper_options(
        dataclasses.asdict(j_dm.DistributedMapperOptions())) == \
        t_dm.DistributedMapperOptions()
    ref.mapper.snapshot_path, ref.mapper.snapshot_images_freq = "/x", 5
    opts = interop.distributed_mapper_options(dataclasses.asdict(ref))
    assert (opts.mapper.snapshot_path, opts.mapper.snapshot_images_freq) \
        == ("/x", 5)
    ref = j_dm.DistributedMapperOptions(num_devices=4)
    with pytest.raises(ValueError, match="parallel/ba_sharded"):
        interop.distributed_mapper_options(dataclasses.asdict(ref))
    assert not hasattr(t_dm.DistributedMapperOptions(), "num_devices")


def test_window_visibility_keeps_points_in_consecutive_views():
    """chip_smoke's distributed-path data: each point stays only in views
    of one window of consecutive ring cameras, within what it saw."""
    from chip_smoke import window_visibility
    sc = t_syn.generate(t_syn.SyntheticSceneSpec(num_cameras=30,
                                                 num_points=400, seed=2))
    w = window_visibility(sc, window=6, seed=2)
    assert not (w.visible & ~sc.visible).any()
    n = w.visible.sum(axis=0)
    assert set(np.unique(n)) <= set(range(7)) - {1}
    for p in np.nonzero(n)[0]:
        views = np.nonzero(w.visible[:, p])[0]
        assert any((((views - v) % 30) < 6).all() for v in views), views
    assert n.sum() > 0.6 * 6 * 400 * sc.visible.mean()
