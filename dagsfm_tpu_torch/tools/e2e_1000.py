"""The whole distributed pipeline at 1000 rendered images, on the card.

    python -m dagsfm_tpu_torch.tools.e2e_1000 [--n 1000] [--work DIR]
        [--out PATH] [--device cuda|cpu]

Counterpart of tools/e2e_1000.py, with its scene and options: n ring
cameras of 256 x 192 (focal 280, seed 12, ring radius 10, max(60, n // 8)
points), rendered -> SIFT (512 features over 3 octaves, 8 images a call)
-> sequential pairs (overlap 4) with BoW loop detection every 10 images
(6 a query) -> K1 matching -> full E/F/H verification (128 hypotheses)
-> view graph -> rotation averaging -> clustering (at most 100 images,
overlap 20, completeness 0.5) -> per-cluster mapping through the lease
worker (`parallel.distributed.run_worker`, mapper seed 0, initial
triangulation angle 2 degrees), which checkpoints each cluster as
partition<k>/ under the work directory -> `load_partitions` -> Sim(3)
merge -> retriangulation -> final BA.

The record has the reference record's keys (registered count and rate,
ATE and mean rotation error against the truth, separator RMSE, points,
verified pairs, clusters, each stage's seconds), plus the cut that
clustered and the cluster sizes, K1's launches, peak device memory and
the card's name and power limit. Its gates are the reference's: at least
90 % of the images registered and ATE < 0.15; `run` raises when one
fails. Each stage clock ends in a sync. Without `--work` the partitions
go to a temporary directory that is removed after the run; with it they
stay, and a run that was cut resumes from the clusters already mapped.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from dagsfm_tpu_torch.tools import common

MIN_REGISTERED = 0.9
MAX_ATE = 0.15


def inputs(n: int, dev):
    """(scene, images, cameras, FeaturePipelineOptions,
    DistributedMapperOptions) of the reference tool at n images."""
    from dagsfm_tpu_torch.clustering.image_clustering import \
        ClusteringOptions
    from dagsfm_tpu_torch.features import sift
    from dagsfm_tpu_torch.pipeline.distributed_mapper import \
        DistributedMapperOptions
    from dagsfm_tpu_torch.pipeline.feature_pipeline import \
        FeaturePipelineOptions
    from dagsfm_tpu_torch.scene import cameras as cm
    from dagsfm_tpu_torch.scene import synthetic
    from dagsfm_tpu_torch.sfm.incremental_mapper import MapperOptions

    spec = synthetic.SyntheticSceneSpec(
        num_cameras=n, num_points=max(60, n // 8), image_width=256,
        image_height=192, focal=280.0, seed=12, ring_radius=10.0,
        point_cloud_extent=4.0, ring_height_jitter=0.2)
    sc = synthetic.generate(spec)
    images = synthetic.render_images(sc, device=dev)
    cams = {i: cm.make_simple_camera(i, spec.image_width, spec.image_height,
                                     focal=spec.focal) for i in images}
    fp_opts = FeaturePipelineOptions(
        pair_mode="sequential", sequential_overlap=4,
        loop_detection_period=10, loop_detection_num_images=6,
        num_ransac_hypotheses=128, batch_size=8)
    fp_opts.sift = sift.SiftOptions(max_num_features=512,
                                    candidates_per_octave=512,
                                    num_octaves=3)
    dm_opts = DistributedMapperOptions(
        clustering=ClusteringOptions(num_images_ub=100, image_overlap=20,
                                     completeness_ratio=0.5),
        mapper=MapperOptions(seed=0, init_min_tri_angle_deg=2.0))
    return sc, images, cams, fp_opts, dm_opts


def pipeline(n: int, dev, secs: dict) -> tuple:
    """The scene rendered at n images, then SIFT, pair selection,
    matching and verification on `dev`, each stage's seconds (ended by a
    sync) into secs. Returns (scene, FeaturePipeline, its selected pairs,
    DistributedMapperOptions)."""
    from dagsfm_tpu_torch.pipeline.feature_pipeline import FeaturePipeline
    with common.stage(secs, "render", dev):
        sc, images, cams, fp_opts, dm_opts = inputs(n, dev)
    fp = FeaturePipeline(images, cams, fp_opts, device=dev)
    with common.stage(secs, "extraction", dev):
        fp.extract_features()
    with common.stage(secs, "pair_selection", dev):
        pairs = fp.select_pairs()
    fp.match_and_verify(pairs)
    common.sync(dev)
    secs["matching"] = fp.timings["matching"]
    secs["verification"] = fp.timings["verification"]
    return sc, fp, pairs, dm_opts


def run(n: int = 1000, work: str | None = None, device=None,
        log=sys.stderr) -> dict:
    """The pipeline at n images on `device` (the card unless told);
    returns the record, raising if a gate fails."""
    dev = common.resolve(device)
    if work is None:
        tmp = tempfile.mkdtemp(prefix="e2e_1000_")
        try:
            return run(n, tmp, dev, log)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    from dagsfm_tpu_torch.ops import matcher_kernel as mk
    from dagsfm_tpu_torch.parallel.distributed import run_worker
    from dagsfm_tpu_torch.pipeline.distributed_mapper import \
        DistributedMapperController
    from dagsfm_tpu_torch.scene import synthetic

    def say(msg):
        print(msg, file=log, flush=True)

    os.makedirs(work, exist_ok=True)
    card = common.card(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    secs = {}
    t_total = time.perf_counter()
    launches0 = mk.launches
    sc, fp, pairs, dm_opts = pipeline(n, dev, secs)
    k1 = mk.launches - launches0
    say(f"on {card}: rendered {n} images in {secs['render']:.3f} s, "
        f"extraction {secs['extraction']:.3f} s, {len(pairs)} pairs "
        f"selected, matching {secs['matching']:.3f} s ({k1} K1 launches), "
        f"verification {secs['verification']:.3f} s "
        f"({fp.num_classified} classified, {len(fp.two_view)} verified)")

    cams2, imgs2, graph = fp.to_mapper_inputs()
    ctrl = DistributedMapperController(
        cams2, imgs2, graph, dm_opts,
        two_view_geometries=fp.two_view_edges(), device=dev)
    with common.stage(secs, "view_graph", dev):
        ctrl.build_view_graph()
    with common.stage(secs, "rotation_averaging", dev):
        ctrl.filter_and_average_rotations()
    with common.stage(secs, "clustering", dev):
        ctrl.cluster_scenes()
    sizes = [len(c.image_ids) for c in ctrl.clusters]
    cut = dm_opts.clustering.cluster_type
    say(f"view graph {secs['view_graph']:.3f} s ({ctrl.view_graph_edges}), "
        f"rotation averaging {secs['rotation_averaging']:.3f} s, "
        f"clustering ({cut}) {secs['clustering']:.3f} s -> {len(sizes)} "
        f"clusters, sizes {sizes}, {ctrl.clustering_summary}")

    with common.stage(secs, "cluster_sfm_lease_workers", dev):
        ctrl.export_cluster_jobs(work)
        with open(os.path.join(work, "clusters.json")) as f:
            jobs = json.load(f)
        done = run_worker(cams2, imgs2, graph, jobs, work, host_id=0,
                          mapper_options=dm_opts.mapper, device=dev)
    say(f"lease worker mapped clusters {done} of {len(jobs)} in "
        f"{secs['cluster_sfm_lease_workers']:.3f} s (any other was already "
        f"under {work})")
    with common.stage(secs, "load_partitions", dev):
        ctrl.load_partitions(work)
    with common.stage(secs, "merge", dev):
        merged = ctrl.merge_clusters()
    with common.stage(secs, "retriangulate", dev):
        ctrl.retriangulate(merged)
    with common.stage(secs, "final_ba", dev):
        ctrl.adjust_global_bundle(merged)
    secs["total"] = time.perf_counter() - t_total

    err = synthetic.pose_errors(merged, sc)
    record = {
        "what": f"{n}-image rendered-scene end-to-end on {dev.type} "
                "(dagsfm_tpu_torch/tools/e2e_1000.py)",
        "num_images": n,
        "registered": err["num_reg"],
        "registration_rate": err["num_reg"] / n,
        "ate": err["ate"],
        "rot_err_deg_mean": err["rot_err_deg_mean"],
        "separator_rmse_px": float(ctrl.separator_rmse(merged)),
        "num_points": merged.num_points3D(),
        "verified_pairs": len(fp.two_view),
        "num_clusters": len(ctrl.clusters),
        "stage_seconds": secs,
        "clustering": {"cut": cut, "sizes": sizes,
                       "summary": ctrl.clustering_summary},
        "view_graph_edges": dict(ctrl.view_graph_edges),
        "k1_launches": k1,
        "clusters_mapped_here": done,
        "peak_device_memory_gib": common.peak_gib(dev),
        "device": dev.type,
        "card": card,
    }
    if not (err["num_reg"] >= MIN_REGISTERED * n and err["ate"] < MAX_ATE):
        raise AssertionError(f"e2e_1000 out of its gates: {record}")
    return record


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--work", default=None,
                    help="partition checkpoints (default: a temporary "
                         "directory, removed after the run)")
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    common.emit(run(args.n, args.work, args.device), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
