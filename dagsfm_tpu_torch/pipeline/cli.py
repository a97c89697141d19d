"""Command-line interface: `python -m dagsfm_tpu_torch <command>`.

Port of dagsfm_tpu/pipeline/cli.py, with the JAX package's flag names
and result lines. Ported so far are the commands of the parallel layer
and those of pair selection on a database of features:

  local_sfm_worker       claim cluster jobs from a work_dir and map them
  local_matching_worker  claim matching jobs from a work_dir: extract,
                         match and verify each into its own database
  distributed_mapper     the whole graph-partitioned pipeline from a
                         database (--distributed 1: the sharded final BA)
  vocab_tree_builder     train a vocab tree on a database's descriptors
                         (an .npz both packages read)
  vocab_tree_retriever   rank a database's images against each other
                         through a vocab tree
  spatial_matcher        match and verify the pairs of nearby location
                         priors (--is_gps 1: WGS84 priors, compared in ENU)
  transitive_matcher     match and verify the transitive closure of the
                         verified pairs

and those of the dense path:

  image_undistorter      a model's cameras and keypoints to PINHOLE, as a
                         COLMAP model or a PMVS / CMP-MVS workspace
  model_converter        a model as BIN, TXT, PLY, NVM or Bundler
  poisson_mesher         a fused point cloud with normals -> Poisson mesh
  delaunay_mesher        a fused point cloud -> Delaunay surface mesh

Every command that computes on a device takes `--device` (default
`cuda`; `cpu` runs on the CPU); model_converter and delaunay_mesher run
on the host alone.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def cmd_local_sfm_worker(args):
    """Worker process: claim the cluster jobs of work_dir/clusters.json by
    lease, map each and publish it as work_dir/partition<k>/."""
    from dagsfm_tpu_torch.parallel.distributed import run_worker
    from dagsfm_tpu_torch.pipeline.feature_pipeline import FeaturePipeline
    fp = FeaturePipeline({}, {}, device=args.device,
                         database_path=args.database_path)
    cams, images, graph = fp.load_from_database(args.database_path)
    with open(os.path.join(args.work_dir, "clusters.json")) as f:
        clusters = json.load(f)
    done = run_worker(cams, images, graph, clusters, args.work_dir,
                      host_id=args.host_id,
                      lease_timeout_s=args.lease_timeout, device=args.device)
    print(f"worker {args.host_id}: completed clusters {done}")
    _print_peak_memory(args.device)


def cmd_local_matching_worker(args):
    """Worker process: claim the matching jobs of
    work_dir/matching_jobs.json (`make_matching_jobs`) by lease; extract,
    match and verify each job's pairs into work_dir/matches<k>.db. Images
    are grayscale arrays in --image_path/image<id>.npy."""
    from dagsfm_tpu_torch.features import sift
    from dagsfm_tpu_torch.parallel.distributed import run_matching_worker
    from dagsfm_tpu_torch.pipeline.feature_pipeline import \
        FeaturePipelineOptions
    from dagsfm_tpu_torch.scene import cameras as cm

    with open(os.path.join(args.work_dir, "matching_jobs.json")) as f:
        jobs = json.load(f)
    images, cams = {}, {}
    for i in sorted({i for j in jobs for i in j["image_ids"]}):
        img = np.load(os.path.join(args.image_path, f"image{i}.npy"))
        images[i] = img
        cams[i] = cm.make_simple_camera(
            i, img.shape[1], img.shape[0],
            focal=args.focal if args.focal > 0 else None)
    opts = FeaturePipelineOptions(batch_size=args.batch_size,
                                  guided_matching=args.guided_matching)
    if args.max_num_features > 0:
        opts.sift = sift.SiftOptions(
            max_num_features=args.max_num_features,
            candidates_per_octave=min(512, args.max_num_features),
            num_octaves=3)
    done = run_matching_worker(images, cams, jobs, args.work_dir,
                               host_id=args.host_id, pipeline_options=opts,
                               lease_timeout_s=args.lease_timeout,
                               device=args.device)
    print(f"matching worker {args.host_id}: completed jobs {done}")
    _print_peak_memory(args.device)


def _print_peak_memory(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def cmd_distributed_mapper(args):
    """The graph-partitioned pipeline on a database's features and
    two-view geometries, the model written to --output_path."""
    from dagsfm_tpu_torch.clustering.image_clustering import \
        ClusteringOptions
    from dagsfm_tpu_torch.pipeline.distributed_mapper import (
        DistributedMapperController, DistributedMapperOptions)
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, load_two_view_geometries_from_database)
    from dagsfm_tpu_torch.scene import io as scene_io
    fp = FeaturePipeline({}, {}, device=args.device,
                         database_path=args.database_path)
    cams, images, graph = fp.load_from_database(args.database_path)
    two_view = load_two_view_geometries_from_database(args.database_path,
                                                      device=args.device)
    opts = DistributedMapperOptions(
        clustering=ClusteringOptions(
            num_images_ub=args.num_images_ub,
            completeness_ratio=args.completeness_ratio,
            relax_ratio=args.relax_ratio,
            image_overlap=args.image_overlap,
            cluster_type=args.cluster_type),
        distributed_final_ba=bool(args.distributed),
        retriangulate=bool(args.retriangulate),
        final_ba=bool(args.final_ba))
    ctrl = DistributedMapperController(cams, images, graph, opts,
                                       two_view_geometries=two_view,
                                       device=args.device)
    rec = ctrl.run()
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(rec, args.output_path)
    print(ctrl.report())
    print(f"registered {rec.num_reg_images()}/{len(images)} images, "
          f"{rec.num_points3D()} points -> {args.output_path}")


def cmd_vocab_tree_builder(args):
    """Train a vocab tree on every descriptor of the database (as stored,
    uint8 values in float32) and save it as an .npz."""
    from dagsfm_tpu_torch.features import visual_index as vi
    from dagsfm_tpu_torch.scene.io import ColmapDatabase
    with ColmapDatabase(args.database_path) as db:
        descs = [np.asarray(d, np.float32) for d in
                 (db.read_descriptors(i) for i in db.read_images()) if len(d)]
    train = np.concatenate(descs)
    opts = vi.VocabTreeOptions(branching=args.branching, depth=args.depth)
    tree = vi.build_vocab_tree(train, opts, device=args.device)
    vi.save_tree(args.vocab_tree_path, tree)
    print(f"vocab tree: {tree.num_words} words from {len(train)} "
          f"descriptors -> {args.vocab_tree_path}")


def cmd_vocab_tree_retriever(args):
    """Index the database's images (descriptors / 512) in a vocab tree and
    print each image's top --num_images others with their scores."""
    from dagsfm_tpu_torch.features import visual_index as vi
    from dagsfm_tpu_torch.scene.io import ColmapDatabase
    index = vi.VisualIndex(vi.load_tree(args.vocab_tree_path,
                                        device=args.device))
    with ColmapDatabase(args.database_path) as db:
        imgs = db.read_images()
        for iid in sorted(imgs):
            d = db.read_descriptors(iid).astype(np.float32) / 512.0
            kp = db.read_keypoints(iid)
            if len(d):
                index.add(iid, d, kp[:, :2])
    for qid in sorted(imgs):
        ranked = index.query(qid, num_images=args.num_images)
        top = ", ".join(f"{imgs[i][0]}({s:.3f})" for i, s in
                        ranked[: args.num_images])
        print(f"{imgs[qid][0]}: {top}")


def cmd_spatial_matcher(args):
    """Match and verify each image with its nearest location priors."""
    from dagsfm_tpu_torch.features.retrieval import spatial_pairs
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        load_features_from_database, run_matcher_on_database)
    from dagsfm_tpu_torch.utils import gps
    *_, priors = load_features_from_database(args.database_path)
    if not priors:
        raise SystemExit("no location priors in database")
    ids = sorted(priors)
    loc = np.stack([priors[i] for i in ids])
    if args.is_gps:
        loc = gps.ell_to_enu(loc)
    pairs = [(i, j) for (i, j, _) in spatial_pairs(
        ids, loc, max_num_neighbors=args.max_num_neighbors,
        max_distance=args.max_distance)]
    n = run_matcher_on_database(args.database_path, pairs,
                                device=args.device)
    print(f"spatial matching: {n}/{len(pairs)} pairs verified")


def cmd_transitive_matcher(args):
    """Match and verify the pairs that close a triangle of verified pairs,
    --batch_size at most per round, for --num_iterations rounds."""
    from dagsfm_tpu_torch.features.retrieval import transitive_pairs
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        load_features_from_database, run_matcher_on_database)
    *_, matched, _ = load_features_from_database(args.database_path)
    total = 0
    for _ in range(args.num_iterations):
        pairs = [(i, j) for (i, j, _) in transitive_pairs(
            matched, num_iterations=1, batch_size=args.batch_size)]
        if not pairs:
            break
        total += run_matcher_on_database(args.database_path, pairs,
                                         device=args.device)
        matched = matched + pairs
    print(f"transitive matching: {total} new pairs verified")


def _read_model(path: str):
    from dagsfm_tpu_torch.scene import io as scene_io
    if os.path.exists(os.path.join(path, "cameras.bin")):
        return scene_io.read_model_bin(path)
    return scene_io.read_model_text(path)


def cmd_model_converter(args):
    """A .bin or text model written as BIN, TXT, PLY, NVM or Bundler (with
    its image list as <output_path>.list.txt)."""
    from dagsfm_tpu_torch.scene import exporters
    from dagsfm_tpu_torch.scene import io as scene_io
    rec = _read_model(args.input_path)
    writers = {
        "BIN": scene_io.write_model_bin, "TXT": scene_io.write_model_text,
        "PLY": scene_io.write_model_ply, "NVM": exporters.write_nvm,
        "Bundler": lambda r, p: exporters.write_bundler(
            r, p, p + ".list.txt")}
    if args.output_type not in writers:
        raise SystemExit(f"unknown output_type {args.output_type}")
    writers[args.output_type](rec, args.output_path)
    print(f"converted -> {args.output_path} ({args.output_type})")


def cmd_image_undistorter(args):
    """A .bin model's cameras and keypoints undistorted to PINHOLE, written
    as a COLMAP model under <output_path>/sparse, or as a PMVS or CMP-MVS
    workspace's metadata."""
    from dagsfm_tpu_torch.scene import exporters
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.scene.undistortion import undistort_reconstruction
    rec = scene_io.read_model_bin(args.input_path)
    und = undistort_reconstruction(rec, device=args.device)
    os.makedirs(args.output_path, exist_ok=True)
    if args.output_type == "PMVS":
        exporters.write_pmvs_workspace(und, args.output_path)
    elif args.output_type == "CMP-MVS":
        exporters.write_cmpmvs_workspace(und, args.output_path)
    else:
        sparse = os.path.join(args.output_path, "sparse")
        os.makedirs(sparse, exist_ok=True)
        scene_io.write_model_bin(und, sparse)
    print(f"undistorted -> {args.output_path} ({args.output_type})")


def cmd_poisson_mesher(args):
    """A fused PLY point cloud with normals -> Poisson mesh PLY (the
    spectral grid solver of mvs/poisson.py)."""
    from dagsfm_tpu_torch.mvs import io as mvs_io
    from dagsfm_tpu_torch.mvs import meshing
    from dagsfm_tpu_torch.mvs.poisson import PoissonOptions, poisson_mesh
    xyz, normals = mvs_io.read_ply_points(args.input_path)
    if normals is None:
        raise SystemExit("poisson_mesher needs a PLY with nx/ny/nz "
                         "normals (run stereo_fusion first)")
    verts, tris = poisson_mesh(
        xyz, normals, PoissonOptions(grid=args.grid, screen=args.screen,
                                     smooth_sigma=args.smooth),
        device=args.device)
    meshing.write_ply_mesh(args.output_path, verts, tris)
    print(f"poisson mesh: {len(verts)} vertices, {len(tris)} triangles "
          f"-> {args.output_path}")


def cmd_delaunay_mesher(args):
    """A fused PLY point cloud -> Delaunay surface mesh PLY."""
    from dagsfm_tpu_torch.mvs import io as mvs_io
    from dagsfm_tpu_torch.mvs import meshing
    xyz, _normals = mvs_io.read_ply_points(args.input_path)
    verts, tris = meshing.delaunay_mesh(
        xyz, meshing.MeshingOptions(max_edge_factor=args.max_edge_factor))
    meshing.write_ply_mesh(args.output_path, verts, tris)
    print(f"delaunay mesh: {len(verts)} vertices, {len(tris)} triangles "
          f"-> {args.output_path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dagsfm_tpu_torch",
        description="Distributed Structure-from-Motion on PyTorch / CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, flags, device=True):
        sp = sub.add_parser(name)
        if device:
            flags = flags + [("--device", dict(default="cuda"))]
        for f, kw in flags:
            sp.add_argument(f, **kw)
        sp.set_defaults(func=fn)

    add("distributed_mapper", cmd_distributed_mapper, [
        ("--database_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--num_images_ub", dict(type=int, default=100)),
        ("--completeness_ratio", dict(type=float, default=0.5)),
        ("--relax_ratio", dict(type=float, default=1.3)),
        ("--image_overlap", dict(type=int, default=50)),
        ("--cluster_type", dict(default="SPECTRAL")),
        ("--distributed", dict(type=int, default=0)),
        ("--retriangulate", dict(type=int, default=0)),
        ("--final_ba", dict(type=int, default=1)),
    ])
    add("local_sfm_worker", cmd_local_sfm_worker, [
        ("--database_path", dict(required=True)),
        ("--work_dir", dict(required=True)),
        ("--host_id", dict(type=int, default=0)),
        ("--lease_timeout", dict(type=float, default=3600.0)),
    ])
    add("local_matching_worker", cmd_local_matching_worker, [
        ("--image_path", dict(required=True)),
        ("--work_dir", dict(required=True)),
        ("--host_id", dict(type=int, default=0)),
        ("--focal", dict(type=float, default=-1.0)),
        ("--batch_size", dict(type=int, default=4)),
        ("--max_num_features", dict(type=int, default=1024)),
        ("--guided_matching", dict(action="store_true")),
        ("--lease_timeout", dict(type=float, default=3600.0)),
    ])
    add("vocab_tree_builder", cmd_vocab_tree_builder, [
        ("--database_path", dict(required=True)),
        ("--vocab_tree_path", dict(required=True)),
        ("--branching", dict(type=int, default=8)),
        ("--depth", dict(type=int, default=2)),
    ])
    add("vocab_tree_retriever", cmd_vocab_tree_retriever, [
        ("--database_path", dict(required=True)),
        ("--vocab_tree_path", dict(required=True)),
        ("--num_images", dict(type=int, default=10)),
    ])
    add("spatial_matcher", cmd_spatial_matcher, [
        ("--database_path", dict(required=True)),
        ("--max_num_neighbors", dict(type=int, default=50)),
        ("--max_distance", dict(type=float, default=100.0)),
        ("--is_gps", dict(type=int, default=0)),
    ])
    add("transitive_matcher", cmd_transitive_matcher, [
        ("--database_path", dict(required=True)),
        ("--batch_size", dict(type=int, default=1000)),
        ("--num_iterations", dict(type=int, default=3)),
    ])
    add("image_undistorter", cmd_image_undistorter, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--output_type", dict(default="COLMAP")),
    ])
    add("model_converter", cmd_model_converter, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--output_type", dict(default="TXT")),
    ], device=False)
    add("poisson_mesher", cmd_poisson_mesher, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--grid", dict(type=int, default=128)),
        ("--screen", dict(type=float, default=4.0)),
        ("--smooth", dict(type=float, default=1.0)),
    ])
    add("delaunay_mesher", cmd_delaunay_mesher, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--max_edge_factor", dict(type=float, default=3.0)),
    ], device=False)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)
