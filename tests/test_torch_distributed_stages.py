"""The port's DistributedMapperController stage by stage against the JAX
package's, each stage fed the reference's own intermediates: on
tests/test_pipeline.py's fixture with two-view geometries given (true
relative poses, 0.3 deg of noise, three wrong), the reference runs every
stage; the port then takes its view graph and gives the rotations to
1e-9 and the same filtered edges, takes its filtered graph and gives
the same clusters (with the reference's spectral start node), takes its
local models and merges them with its RANSAC samples into the same
model, retriangulates its merged model the same way, and solves its
final BA problem to rel 1e-7."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from dagsfm_tpu.clustering import image_clustering as j_ic
from dagsfm_tpu.pipeline import distributed_mapper as j_dm
from dagsfm_tpu.scene import synthetic as j_syn
from dagsfm_tpu.sfm import incremental_mapper as j_im
from dagsfm_tpu_torch import interop
from dagsfm_tpu_torch.clustering import spectral as t_sp
from dagsfm_tpu_torch.pipeline import distributed_mapper as t_dm
from dagsfm_tpu_torch.sfm import aligner as t_al
from dagsfm_tpu_torch.sfm.correspondence_graph import CorrespondenceGraph
from tests.test_torch_aligner import assert_same_model, port, \
    reference_samples
from tests.test_torch_clustering import reference_start
from tests.test_torch_distributed_mapper import (noisy_geometries,
                                                 pipeline_options,
                                                 pipeline_problem)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stages():
    """The reference's run, stage by stage, with copies of what each stage
    handed to the next."""
    sc, (cams, images, graph) = pipeline_problem(j_syn)
    geo = noisy_geometries(sc, graph)
    ref_opts = j_dm.DistributedMapperOptions(   # test_pipeline.py's
        clustering=j_ic.ClusteringOptions(num_images_ub=10, image_overlap=6,
                                          completeness_ratio=0.5),
        mapper=j_im.MapperOptions(init_min_num_inliers=30,
                                  num_ransac_hypotheses=256, seed=11),
        final_ba_iterations=25, seed=5)
    opts = interop.distributed_mapper_options(dataclasses.asdict(ref_opts))
    ref = j_dm.DistributedMapperController(cams, images, graph, ref_opts,
                                           two_view_geometries=geo)
    out = {"sc": sc, "geo": geo, "opts": opts, "ref": ref,
           "problem": (cams, images, graph)}
    out["built"] = copy.deepcopy(ref.build_view_graph())
    ref.filter_and_average_rotations()
    out["filtered"] = copy.deepcopy(ref.view_graph)
    ref.cluster_scenes()
    out["local"] = copy.deepcopy(ref.reconstruct_partitions())
    merged = ref.merge_clusters()
    out["merged"] = copy.deepcopy(merged)
    ref.retriangulate(merged)
    out["retriangulated"] = copy.deepcopy(merged)
    ref.adjust_global_bundle(merged)
    out["final"] = merged
    return out


def _port_controller(stages):
    cams, images, graph = stages["problem"]
    g = CorrespondenceGraph()
    for i, n in graph.num_keypoints.items():
        g.add_image(i, n)
    for (i, j), m in graph.pair_matches.items():
        g.add_matches(i, j, m)
    return t_dm.DistributedMapperController(
        {c: interop.camera(x) for c, x in cams.items()},
        {i: interop.image_record(x) for i, x in images.items()}, g,
        stages["opts"], two_view_geometries=stages["geo"], device="cpu")


def test_options_are_the_reference_runs(stages):
    assert stages["opts"] == pipeline_options()


def test_view_graph_and_rotations(stages):
    ctrl = _port_controller(stages)
    built = ctrl.build_view_graph()
    assert list(built.edges) == list(stages["built"].edges)
    ctrl.view_graph = interop.view_graph(stages["built"])
    ctrl.filter_and_average_rotations()
    ref = stages["ref"]
    assert list(ctrl.view_graph.edges) == list(ref.view_graph.edges)
    assert ctrl.view_graph.nodes == ref.view_graph.nodes
    assert ctrl.global_rotations.keys() == ref.global_rotations.keys()
    for v, R in ref.global_rotations.items():
        np.testing.assert_allclose(ctrl.global_rotations[v], R, rtol=1e-9,
                                   atol=1e-9)
    assert ctrl.view_graph_edges["built"] > ctrl.view_graph_edges["final"]


def test_clusters(stages, monkeypatch):
    monkeypatch.setattr(t_sp, "_draw_start", reference_start)
    ctrl = _port_controller(stages)
    ctrl.view_graph = interop.view_graph(stages["filtered"])
    ctrl.cluster_scenes()
    want = [(c.cluster_id, c.image_ids, c.edges)
            for c in stages["ref"].clusters]
    assert [(c.cluster_id, c.image_ids, c.edges)
            for c in ctrl.clusters] == want
    assert ctrl.clustering_summary == stages["ref"].clustering_summary
    assert len(want) >= 2


def test_merge_of_the_reference_local_models(stages, monkeypatch):
    opts = stages["opts"].aligner
    monkeypatch.setattr(t_al.SfMAligner, "_sample_indices",
                        reference_samples(opts.seed, opts.ransac_iters))
    ctrl = _port_controller(stages)
    ctrl.local_recons = [port(r) for r in stages["local"]]
    merged = ctrl.merge_clusters()
    assert ctrl.separators == stages["ref"].separators
    assert len(ctrl.separators) >= 2
    assert_same_model(stages["merged"], merged)


def test_retriangulation_of_the_reference_merged_model(stages):
    ctrl = _port_controller(stages)
    ctrl.separators = list(stages["ref"].separators)
    merged = port(stages["merged"])
    ctrl.retriangulate(merged)
    assert_same_model(stages["retriangulated"], merged)


def test_final_ba_of_the_reference_merged_model(stages):
    ctrl = _port_controller(stages)
    ctrl.separators = list(stages["ref"].separators)
    merged = port(stages["retriangulated"])
    ctrl.adjust_global_bundle(merged)
    st, ref_st = ctrl.ba_stats, stages["ref"].ba_stats
    assert st.num_iterations == int(ref_st.num_iterations)
    assert st.final_cost == pytest.approx(float(ref_st.final_cost), rel=1e-7)
    assert_same_model(stages["final"], merged, tol=1e-7)
    assert ctrl.separator_rmse(merged) == pytest.approx(
        stages["ref"].separator_rmse(stages["final"]), rel=1e-7)
    errs = j_syn.pose_errors(stages["final"], stages["sc"])
    assert errs["ate"] < 0.05, errs
