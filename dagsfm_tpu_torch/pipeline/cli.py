"""Command-line interface: `python -m dagsfm_tpu_torch <command>`.

Port of dagsfm_tpu/pipeline/cli.py, with the JAX package's flag names
and result lines, and all 38 of its commands: those of the parallel
layer and of pair selection on a database of features:

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

the commands on a database or a model:

  mapper                 incremental mapping of a database into models
                         under output_path/0, /1, ...
  point_triangulator     triangulate a model's images from the database,
                         poses held
  image_registrator      register the database's other images into a
                         model, no triangulation or BA
  bundle_adjuster        global BA of a model (first two images held)
  rig_bundle_adjuster    rig-constrained BA under a JSON rig config
  sfm_aligner            merge the models in a directory's subdirectories
  model_merger           merge two overlapping models by Sim(3)
  model_aligner          Sim(3)-align a model to reference camera centres
  model_analyzer         a model's statistics as one JSON line
  point_filtering        delete points by track length and error
  image_deleter          deregister images listed by id or name
  image_filterer         deregister images by intrinsics and observations
  database_creator       an empty database
  database_merger        two databases merged into a new one
  matches_importer       raw matches from a text file into a database
  feature_importer       features from COLMAP text files into a database
  project_generator      a project .ini with a quality preset
  synthetic_scene        a synthetic ring scene's ground-truth model

and the commands on a directory of photos (read with PIL, as the JAX
package reads them; without PIL they exit with its message):

  feature_extractor      SIFT over the photos into a database, cameras
                         from EXIF (--camera_model, --single_camera,
                         --camera_params, --default_focal_length_factor)
  exhaustive_matcher /   extract, match and verify the photos into a
  sequential_matcher /   database, every pair / sequential pairs /
  vocab_tree_matcher /   retrieval pairs / global-descriptor pairs
  global_matcher
  automatic_reconstructor  photos -> workspace/database.db and
                         workspace/sparse/0 (exhaustive pairs, mapping)
  color_extractor        colour a model's points from its photos
  image_rectifier        stereo-rectify listed pairs of a model's photos
                         into .npz files (left, right, Q)
  model_orientation_aligner  rotate a model to gravity from its image
                         orientations, or to the Manhattan frame of its
                         photos' lines

Each photo command is a loader (`_load_images_and_cameras`,
`_load_color_images`) and a body that takes the decoded arrays
(`feature_extractor`, `run_matcher`, `automatic_reconstructor`,
`color_extractor`, `image_rectifier`, `model_orientation_aligner`), so
decoded arrays can go through the same bodies without files.

Every command that computes on a device takes `--device` (default
`cuda`; `cpu` runs on the CPU); the others run on the host alone.
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


def _image_reader_opts(args):
    """ImageReaderOptions from the --ImageReader flags."""
    from dagsfm_tpu_torch.scene.image_reader import ImageReaderOptions
    return ImageReaderOptions(
        camera_model=args.camera_model,
        single_camera=bool(args.single_camera),
        camera_params=args.camera_params or "",
        default_focal_length_factor=args.default_focal_length_factor)


def _load_images_and_cameras(args):
    """A directory -> (images, names, cameras) with EXIF focal priors."""
    from dagsfm_tpu_torch.scene.image_reader import read_images_with_cameras
    return read_images_with_cameras(args.image_path,
                                    _image_reader_opts(args))


def feature_extractor(images: dict, cams: dict, database_path: str,
                      sift_options, device=None):
    """feature_extractor's body: SIFT of the decoded images written to
    the database (cameras, images, keypoints, descriptors). Returns the
    FeaturePipeline."""
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)
    opts = FeaturePipelineOptions()
    opts.sift = sift_options
    fp = FeaturePipeline(images, cams, opts, device=device,
                         database_path=database_path)
    fp.extract_features()
    fp.write_database()
    return fp


def cmd_feature_extractor(args):
    from dagsfm_tpu_torch.features import sift
    images, _names, cams = _load_images_and_cameras(args)
    feature_extractor(images, cams, args.database_path, sift.SiftOptions(
        max_num_features=args.max_num_features,
        first_octave=args.first_octave, num_octaves=args.num_octaves,
        max_image_size=args.max_image_size), device=args.device)
    print(f"extracted features for {len(images)} images "
          f"-> {args.database_path}")


def run_matcher(images: dict, cams: dict, database_path: str, mode: str,
                device=None):
    """The matchers' body: extract, match (pair_mode `mode`) and verify
    into the database, or load it where it holds two-view geometries
    already. Returns the FeaturePipeline."""
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)
    fp = FeaturePipeline(images, cams, FeaturePipelineOptions(pair_mode=mode),
                         device=device, database_path=database_path)
    fp.run()
    return fp


def _run_matcher(args, mode):
    images, _names, cams = _load_images_and_cameras(args)
    fp = run_matcher(images, cams, args.database_path, mode, args.device)
    print(f"matched ({mode}); two-view geometries: {len(fp.two_view)}")


def cmd_exhaustive_matcher(args):
    _run_matcher(args, "exhaustive")


def cmd_sequential_matcher(args):
    _run_matcher(args, "sequential")


def cmd_vocab_tree_matcher(args):
    """The JAX package's vocab_tree_matcher runs pair_mode "retrieval"
    (BoW retrieval), and so does this one."""
    _run_matcher(args, "retrieval")


def cmd_global_matcher(args):
    """Global-descriptor (VLAD over SIFT) nearest-neighbour pairs."""
    _run_matcher(args, "global")


def automatic_reconstructor(images: dict, cams: dict, workspace_path: str,
                            device=None):
    """automatic_reconstructor's body: exhaustive extraction, matching
    and verification into workspace/database.db, incremental mapping,
    the model written to workspace/sparse/0. Returns (the model, its
    directory, the FeaturePipeline)."""
    from dagsfm_tpu_torch.pipeline.feature_pipeline import (
        FeaturePipeline, FeaturePipelineOptions)
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                         MapperOptions)
    db = os.path.join(workspace_path, "database.db")
    os.makedirs(workspace_path, exist_ok=True)
    fp = FeaturePipeline(images, cams,
                         FeaturePipelineOptions(pair_mode="exhaustive"),
                         device=device, database_path=db)
    cams2, imgs2, graph = fp.run()
    rec = IncrementalMapper(cams2, imgs2, graph, MapperOptions(),
                            device=device).reconstruct()
    out = os.path.join(workspace_path, "sparse", "0")
    scene_io.write_model_bin(rec, out)
    return rec, out, fp


def cmd_automatic_reconstructor(args):
    """One-click sparse pipeline (AutomaticReconstructionController)."""
    images, _names, cams = _load_images_and_cameras(args)
    rec, out, _ = automatic_reconstructor(images, cams, args.workspace_path,
                                          args.device)
    print(f"reconstruction: {rec.num_reg_images()} images, "
          f"{rec.num_points3D()} points -> {out}")


def _load_color_images(image_path: str, names_wanted=None) -> dict:
    """RGB float32 arrays in [0, 1] keyed by file name."""
    from dagsfm_tpu_torch.scene.image_reader import image_files
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit("image loading requires PIL") from e
    out = {}
    for f in image_files(image_path):
        if names_wanted is not None and f not in names_wanted:
            continue
        img = Image.open(os.path.join(image_path, f)).convert("RGB")
        out[f] = np.asarray(img, np.float32) / 255.0
    return out


def color_extractor(rec, by_name: dict) -> int:
    """color_extractor's body: each point's colour from the images (by
    file name) of the model's images. Returns the points coloured."""
    return rec.extract_colors({i: by_name[im.name]
                               for i, im in rec.images.items()
                               if im.name in by_name})


def cmd_color_extractor(args):
    """Colour a model's 3D points from its photos."""
    from dagsfm_tpu_torch.scene import io as scene_io
    rec = _read_model(args.input_path)
    by_name = _load_color_images(args.image_path,
                                 {im.name for im in rec.images.values()})
    n = color_extractor(rec, by_name)
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(rec, args.output_path)
    print(f"colored {n}/{rec.num_points3D()} points")


def _stereo_pairs(path: str) -> list:
    """The `name1 name2` lines of a pair list (other lines skipped)."""
    with open(path) as f:
        return [tuple(ln.split()) for ln in f if len(ln.split()) == 2]


def image_rectifier(rec, by_name: dict, pairs: list, output_path: str,
                    device=None) -> int:
    """image_rectifier's body: each listed pair of the model's images
    (RGB by file name, averaged to grey) undistorted and rectified by
    their relative pose, saved as <stem1>-<stem2>.npz with left, right
    and Q. Returns the pairs written."""
    from dagsfm_tpu_torch.ops import rotations as rops
    from dagsfm_tpu_torch.scene.undistortion import (
        rectify_and_undistort_stereo_pair)
    by_id = {im.name: i for i, im in rec.images.items()}
    os.makedirs(output_path, exist_ok=True)
    for name1, name2 in pairs:
        im1, im2 = rec.images[by_id[name1]], rec.images[by_id[name2]]
        R1 = rops.quat_to_rotmat_np(im1.qvec)
        R2 = rops.quat_to_rotmat_np(im2.qvec)
        # relative pose 2-from-1
        R12 = R2 @ R1.T
        t12 = im2.tvec - R12 @ im1.tvec
        r1, r2, Q = rectify_and_undistort_stereo_pair(
            np.mean(by_name[name1], axis=2), np.mean(by_name[name2], axis=2),
            rec.cameras[im1.camera_id], rec.cameras[im2.camera_id],
            rops.rotmat_to_quat_np(R12), t12, device=device)
        stem = f"{os.path.splitext(name1)[0]}-{os.path.splitext(name2)[0]}"
        np.savez(os.path.join(output_path, stem + ".npz"),
                 left=r1, right=r2, Q=Q)
    return len(pairs)


def cmd_image_rectifier(args):
    """Stereo-rectify the image pairs of a list file, `name1 name2` per
    line."""
    rec = _read_model(args.input_path)
    n = image_rectifier(rec, _load_color_images(args.image_path),
                        _stereo_pairs(args.stereo_pairs_list),
                        args.output_path, args.device)
    print(f"rectified {n} stereo pairs -> {args.output_path}")


def model_orientation_aligner(rec, method: str, images: dict | None = None,
                              max_image_size: int = 1024, device=None):
    """model_orientation_aligner's body: the rotation of the chosen
    method ("image-orientation": the consensus of the images' down axes
    onto +y; "manhattan-world": the Manhattan frame of `images`, grey
    arrays by image id, on `device`) applied to the model in place.
    Returns (the rotation, the Manhattan frame or None)."""
    from dagsfm_tpu_torch.estimation import coordinate_frame as cf
    frame = None
    if method == "image-orientation":
        gravity = cf.estimate_gravity_vector_from_image_orientation(rec)
        tform = cf.rotation_from_unit_vectors(gravity, [0, 1, 0])
    elif method == "manhattan-world":
        frame = cf.estimate_manhattan_world_frame(
            rec, images, cf.ManhattanOptions(max_image_size=max_image_size),
            device=device)
        tform = cf.align_to_manhattan_world(rec, frame)
    else:
        raise SystemExit("ERROR: Invalid `method` - supported values are "
                         "'MANHATTAN-WORLD' or 'IMAGE-ORIENTATION'.")
    rec.transform(1.0, np.asarray(tform, float), np.zeros(3))
    return tform, frame


def cmd_model_orientation_aligner(args):
    """Align a model's frame to gravity or to the Manhattan axes."""
    from dagsfm_tpu_torch.scene import io as scene_io
    rec = _read_model(args.input_path)
    method = args.method.lower()
    images = None
    if method == "manhattan-world":
        by_name = _load_color_images(
            args.image_path, {im.name for im in rec.images.values()})
        images = {i: np.mean(by_name[im.name], axis=2)
                  for i, im in rec.images.items() if im.name in by_name}
    model_orientation_aligner(rec, method, images, args.max_image_size,
                              args.device)
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(rec, args.output_path)
    print(f"aligned ({method}) -> {args.output_path}")


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


def cmd_mapper(args):
    """Multi-model incremental mapping of a database's verified matches;
    the models written under output_path/0, /1, ... (no snapshots)."""
    from dagsfm_tpu_torch.pipeline.feature_pipeline import FeaturePipeline
    from dagsfm_tpu_torch.sfm.mapper_controller import (ControllerOptions,
                                                        MapperController)
    fp = FeaturePipeline({}, {}, device=args.device,
                         database_path=args.database_path)
    cams, images, graph = fp.load_from_database(args.database_path)
    mgr = MapperController(cams, images, graph, ControllerOptions(),
                           device=args.device).run()
    mgr.write(args.output_path)
    for k, rec in enumerate(mgr):
        print(f"model {k}: {rec.num_reg_images()} images, "
              f"{rec.num_points3D()} points")
    total = sum(r.num_reg_images() for r in mgr)
    print(f"registered {total}/{len(images)} images in {len(mgr)} "
          f"model(s) -> {args.output_path}")


def cmd_sfm_aligner(args):
    """Merge the .bin models in input_path's subdirectories (sorted by
    name) by Sim(3) into one."""
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.sfm.aligner import SfMAligner
    recs = []
    for d in sorted(os.listdir(args.input_path)):
        p = os.path.join(args.input_path, d)
        if os.path.isdir(p) and os.path.exists(
                os.path.join(p, "cameras.bin")):
            recs.append(scene_io.read_model_bin(p))
    if not recs:
        raise SystemExit("no partial reconstructions found")
    merged = SfMAligner(recs, device=args.device).align()
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(merged, args.output_path)
    print(f"merged {len(recs)} partitions -> {merged.num_reg_images()} "
          f"images, {merged.num_points3D()} points")


def cmd_bundle_adjuster(args):
    """Global bundle adjustment of a .bin model, its first two images
    held constant."""
    from dagsfm_tpu_torch import device as devmod
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
    rec = scene_io.read_model_bin(args.input_path)
    arrays, ids = rec.to_arrays(devmod.resolve(args.device))
    const = np.zeros(arrays.image_qvec.shape[0], bool)
    const[:2] = True
    prob, stats = ba.solve(ba.make_problem(arrays, const_image=const),
                           ba.BAOptions(max_iterations=args.max_num_iterations))
    rec.update_from_arrays(arrays._replace(
        image_qvec=prob.image_qvec, image_tvec=prob.image_tvec,
        points_xyz=prob.points), ids)
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(rec, args.output_path)
    print(f"BA cost {float(stats.initial_cost):.2f} -> "
          f"{float(stats.final_cost):.2f}")


def cmd_database_creator(args):
    """An empty database with COLMAP's schema."""
    from dagsfm_tpu_torch.scene.io import ColmapDatabase
    ColmapDatabase(args.database_path).close()
    print(f"created {args.database_path}")


def cmd_matches_importer(args):
    """Raw matches from a text file into the database: blocks of a
    'name1 name2' line, then 'i j' keypoint rows, blank-line separated."""
    from dagsfm_tpu_torch.scene.io import ColmapDatabase
    n = 0
    with ColmapDatabase(args.database_path) as db:
        name_to_id = {name: iid for iid, (name, _)
                      in db.read_images().items()}
        cur_pair, rows = None, []

        def flush():
            nonlocal n
            if cur_pair and rows:
                db.add_matches(cur_pair[0], cur_pair[1],
                               np.asarray(rows, np.uint32))
                n += 1
            rows.clear()

        with open(args.match_list_path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    flush()
                    cur_pair = None
                elif len(parts) == 2 and parts[0] in name_to_id:
                    flush()
                    cur_pair = (name_to_id[parts[0]], name_to_id[parts[1]])
                elif cur_pair and len(parts) == 2:
                    rows.append((int(parts[0]), int(parts[1])))
        flush()
    print(f"imported matches for {n} pairs")


def _seeded_mapper(args, rec, with_points: bool):
    """An IncrementalMapper over the database's images and matches with
    the model's registered poses installed (matched by image name), and
    with its points where `with_points` (tracks kept on registered
    images, at least two)."""
    from dagsfm_tpu_torch.pipeline.feature_pipeline import FeaturePipeline
    from dagsfm_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                         MapperOptions)
    fp = FeaturePipeline({}, {}, device=args.device,
                         database_path=args.database_path)
    cams, images, graph = fp.load_from_database(args.database_path)
    mapper = IncrementalMapper(cams, images, graph, MapperOptions(),
                               device=args.device)
    name_to_db = {im.name: iid for iid, im in images.items()}
    for iid in rec.reg_image_ids:
        did = name_to_db.get(rec.images[iid].name)
        if did is None:
            continue
        mapper.rec.images[did].qvec = rec.images[iid].qvec
        mapper.rec.images[did].tvec = rec.images[iid].tvec
        mapper.rec.register_image(did)
    if with_points:
        for pt in rec.points3D.values():
            track = []
            for (iid, kp) in pt.track:
                did = name_to_db.get(rec.images[iid].name)
                if did is not None and mapper.rec.images[did].registered:
                    track.append((did, kp))
            if len(track) >= 2:
                mapper.rec.add_point3D(pt.xyz, track, color=pt.color,
                                       error=pt.error)
    return mapper


def cmd_point_triangulator(args):
    """Triangulate a .bin model's registered images, poses held, from the
    database's matches."""
    from dagsfm_tpu_torch.scene import io as scene_io
    mapper = _seeded_mapper(args, scene_io.read_model_bin(args.input_path),
                            with_points=False)
    n_tri = sum(mapper.triangulate_image(did)
                for did in mapper.rec.reg_image_ids)
    out = mapper.rec
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(out, args.output_path)
    print(f"triangulated {n_tri} observations, "
          f"{out.num_points3D()} points -> {args.output_path}")


def cmd_image_registrator(args):
    """Register the database's other images into a model (its poses and
    points kept) by 2D-3D RANSAC, with no triangulation or BA."""
    from dagsfm_tpu_torch.scene import io as scene_io
    mapper = _seeded_mapper(args, _read_model(args.input_path),
                            with_points=True)
    n = 0
    for did in sorted(mapper.rec.images):
        if not mapper.rec.images[did].registered and \
                mapper.register_next_image(did):
            n += 1
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(mapper.rec, args.output_path)
    print(f"registered {n} new images "
          f"({mapper.rec.num_reg_images()} total)")


def cmd_model_analyzer(args):
    """A .bin model's statistics as one JSON line."""
    from dagsfm_tpu_torch.scene import io as scene_io
    rec = scene_io.read_model_bin(args.input_path)
    tr = [len(p.track) for p in rec.points3D.values()]
    obs = int(np.sum(tr)) if tr else 0
    print(json.dumps({
        "num_cameras": len(rec.cameras),
        "num_images": len(rec.images),
        "num_reg_images": rec.num_reg_images(),
        "num_points3D": rec.num_points3D(),
        "num_observations": obs,
        "mean_track_length": round(float(np.mean(tr)) if tr else 0.0, 3),
        "mean_observations_per_image": round(
            obs / max(rec.num_reg_images(), 1), 3),
        "mean_reprojection_error_px": round(
            rec.compute_mean_reprojection_error(), 4),
    }))


def cmd_model_merger(args):
    """Merge two overlapping .bin models by Sim(3)."""
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.sfm.aligner import SfMAligner
    merged = SfMAligner([scene_io.read_model_bin(args.input_path1),
                         scene_io.read_model_bin(args.input_path2)],
                        device=args.device).align()
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(merged, args.output_path)
    print(f"merged -> {merged.num_reg_images()} images, "
          f"{merged.num_points3D()} points")


def cmd_model_aligner(args):
    """Sim(3)-align a .bin model to reference camera centres, one
    `name x y z` line each (Umeyama on the registered images named)."""
    from dagsfm_tpu_torch.ops import rotations as rops
    from dagsfm_tpu_torch.ops.umeyama import umeyama_np
    from dagsfm_tpu_torch.scene import io as scene_io
    rec = scene_io.read_model_bin(args.input_path)
    refs = {}
    with open(args.ref_images_path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 4:
                refs[p[0]] = [float(x) for x in p[1:4]]
    src, dst = [], []
    for iid in rec.reg_image_ids:
        im = rec.images[iid]
        if im.name in refs:
            src.append(-rops.quat_to_rotmat_np(im.qvec).T @ im.tvec)
            dst.append(refs[im.name])
    if len(src) < 3:
        raise SystemExit("need >= 3 reference locations")
    src, dst = np.stack(src), np.stack(dst)
    s, R, t = umeyama_np(src, dst, with_scale=True)
    rec.transform(float(s), np.asarray(R), np.asarray(t))
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(rec, args.output_path)
    err = np.linalg.norm(float(s) * src @ np.asarray(R).T + np.asarray(t)
                         - dst, axis=1)
    print(f"aligned with {len(src)} refs, mean error "
          f"{err.mean():.4f} -> {args.output_path}")


def cmd_point_filtering(args):
    """Delete the points of short tracks or large reprojection error."""
    from dagsfm_tpu_torch.scene import io as scene_io
    rec = scene_io.read_model_bin(args.input_path)
    drop = [pid for pid, pt in rec.points3D.items()
            if len(pt.track) < args.min_track_len
            or (pt.error >= 0 and pt.error > args.max_reproj_error)]
    for pid in drop:
        rec.delete_point3D(pid)
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(rec, args.output_path)
    print(f"filtered {len(drop)} points, kept {rec.num_points3D()}")


def cmd_database_merger(args):
    """Merge two databases into a new one."""
    from dagsfm_tpu_torch.scene.io import ColmapDatabase
    if os.path.exists(args.merged_database_path):
        raise SystemExit("ERROR: Merged database file must not exist.")
    with ColmapDatabase(args.database_path1) as db1, \
            ColmapDatabase(args.database_path2) as db2, \
            ColmapDatabase(args.merged_database_path) as out:
        ColmapDatabase.merge(db1, db2, out)
        n_img = len(out.read_images())
        n_tvg = out.num_two_view_geometries()
    print(f"merged -> {n_img} images, {n_tvg} two-view geometries")


def cmd_project_generator(args):
    """A project .ini with a quality preset applied."""
    from dagsfm_tpu_torch.utils.options import (ProjectOptions,
                                                apply_quality_preset,
                                                save_project)
    opts = ProjectOptions()
    apply_quality_preset(opts, args.quality.lower())
    save_project(opts, args.output_path)
    print(f"project ({args.quality}) -> {args.output_path}")


def cmd_feature_importer(args):
    """Features from COLMAP text files `<image name>.txt` (a header `N
    128`, then rows `x y scale orientation d0 .. d127`); an image the
    database lacks gets a new default camera. Descriptors are
    renormalised to 512 and stored as uint8."""
    from dagsfm_tpu_torch.scene import cameras as cm
    from dagsfm_tpu_torch.scene.io import ColmapDatabase
    n_img = 0
    with ColmapDatabase(args.database_path) as db:
        existing = {name: iid for iid, (name, _) in db.read_images().items()}
        for fname in sorted(os.listdir(args.import_path)):
            if not fname.endswith(".txt"):
                continue
            name = fname[:-4]
            rows = np.loadtxt(os.path.join(args.import_path, fname),
                              skiprows=1, ndmin=2)
            if name in existing:
                iid = existing[name]
            else:
                cam = cm.make_simple_camera(len(existing) + n_img + 1,
                                            args.default_width,
                                            args.default_height)
                db.add_camera(cam)
                iid = db.add_image(name, cam.camera_id)
            if rows.size:
                db.add_keypoints(iid, rows[:, :4].astype(np.float32))
                desc = rows[:, 4:132]
                norm = np.linalg.norm(desc, axis=1, keepdims=True)
                db.add_descriptors(iid, np.clip(np.round(
                    desc / np.maximum(norm, 1e-9) * 512), 0, 255).astype(
                    np.uint8))
            n_img += 1
    print(f"imported features for {n_img} images")


def cmd_image_deleter(args):
    """Deregister the images listed by id and by name (one per line)."""
    from dagsfm_tpu_torch.scene import io as scene_io
    rec = _read_model(args.input_path)
    by_name = {im.name: i for i, im in rec.images.items()}
    n = 0
    for path, key in ((args.image_ids_path, "image_id"),
                      (args.image_names_path, "image_name")):
        if not path:
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                value = int(line) if key == "image_id" else line
                iid = value if key == "image_id" else by_name.get(value)
                if iid in rec.images and rec.images[iid].registered:
                    rec.deregister_image(iid)
                    n += 1
                else:
                    print(f"WARNING: Skipping {key}={value}")
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(rec, args.output_path)
    print(f"deleted {n} images")


def cmd_image_filterer(args):
    """Deregister the images of cameras with implausible intrinsics, then
    those that see fewer than --min_num_observations points."""
    from dagsfm_tpu_torch.scene import io as scene_io
    rec = _read_model(args.input_path)
    before = rec.num_reg_images()
    rec.filter_images(args.min_focal_length_ratio,
                      args.max_focal_length_ratio, args.max_extra_param)
    for iid in [i for i in rec.reg_image_ids
                if rec.images[i].num_points3D() < args.min_num_observations]:
        rec.deregister_image(iid)
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(rec, args.output_path)
    print(f"Filtered {before - rec.num_reg_images()} images "
          f"from a total of {before} images")


def cmd_rig_bundle_adjuster(args):
    """Rig-constrained global BA of a model under a JSON rig config; the
    mounts refined unless --refine_relative_poses 0."""
    from dagsfm_tpu_torch.scene import camera_rig as crig
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.sfm import rig_bundle_adjustment as rba
    rec = _read_model(args.input_path)
    rigs = crig.read_rig_config(args.rig_config_path, rec)
    for k, rig in enumerate(rigs):
        print(f"Camera Rig {k + 1}: {rig.num_cameras} cameras, "
              f"{rig.num_snapshots} snapshots")
    prob, meta = crig.make_rig_ba_problem(rec, rigs, device=args.device)
    out = rba.solve(prob, rba.RigBAOptions(
        max_iterations=args.max_num_iterations,
        refine_relative_poses=bool(args.refine_relative_poses)))
    crig.apply_rig_ba_result(rec, rigs, out, meta)
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(rec, args.output_path)
    print(f"rig BA cost {float(out.initial_cost):.2f} -> "
          f"{float(out.final_cost):.2f}")


def cmd_synthetic_scene(args):
    """A synthetic ring scene's ground-truth model (every image
    registered) as .bin."""
    from dagsfm_tpu_torch.scene import io as scene_io
    from dagsfm_tpu_torch.scene import synthetic
    sc = synthetic.generate(synthetic.SyntheticSceneSpec(
        num_cameras=args.num_cameras, num_points=args.num_points,
        pixel_noise=args.pixel_noise, seed=args.seed))
    os.makedirs(args.output_path, exist_ok=True)
    scene_io.write_model_bin(synthetic.to_reconstruction(sc),
                             args.output_path)
    print(json.dumps({"num_cameras": args.num_cameras,
                      "num_points": args.num_points,
                      "output": args.output_path}))


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

    # the --ImageReader flags
    image_reader_flags = [
        ("--camera_model", dict(default="SIMPLE_RADIAL")),
        ("--single_camera", dict(type=int, default=0)),
        ("--camera_params", dict(default="")),
        ("--default_focal_length_factor", dict(type=float, default=1.2)),
    ]
    add("feature_extractor", cmd_feature_extractor, [
        ("--image_path", dict(required=True)),
        ("--database_path", dict(required=True)),
        ("--max_num_features", dict(type=int, default=8192)),
        ("--first_octave", dict(type=int, default=-1)),
        ("--num_octaves", dict(type=int, default=0)),
        ("--max_image_size", dict(type=int, default=3200)),
    ] + image_reader_flags)
    for name, fn in (("exhaustive_matcher", cmd_exhaustive_matcher),
                     ("sequential_matcher", cmd_sequential_matcher),
                     ("vocab_tree_matcher", cmd_vocab_tree_matcher),
                     ("global_matcher", cmd_global_matcher)):
        add(name, fn, [
            ("--image_path", dict(required=True)),
            ("--database_path", dict(required=True)),
        ] + image_reader_flags)
    add("automatic_reconstructor", cmd_automatic_reconstructor, [
        ("--image_path", dict(required=True)),
        ("--workspace_path", dict(required=True)),
    ] + image_reader_flags)
    add("color_extractor", cmd_color_extractor, [
        ("--image_path", dict(required=True)),
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
    ], device=False)
    add("image_rectifier", cmd_image_rectifier, [
        ("--image_path", dict(required=True)),
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--stereo_pairs_list", dict(required=True)),
    ])
    add("model_orientation_aligner", cmd_model_orientation_aligner, [
        ("--image_path", dict(default="")),
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--method", dict(default="MANHATTAN-WORLD")),
        ("--max_image_size", dict(type=int, default=1024)),
    ])
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
    add("mapper", cmd_mapper, [
        ("--database_path", dict(required=True)),
        ("--output_path", dict(required=True)),
    ])
    add("sfm_aligner", cmd_sfm_aligner, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
    ])
    add("bundle_adjuster", cmd_bundle_adjuster, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--max_num_iterations", dict(type=int, default=50)),
    ])
    add("synthetic_scene", cmd_synthetic_scene, [
        ("--output_path", dict(required=True)),
        ("--num_cameras", dict(type=int, default=20)),
        ("--num_points", dict(type=int, default=500)),
        ("--pixel_noise", dict(type=float, default=0.5)),
        ("--seed", dict(type=int, default=0)),
    ], device=False)
    add("database_creator", cmd_database_creator, [
        ("--database_path", dict(required=True)),
    ], device=False)
    add("matches_importer", cmd_matches_importer, [
        ("--database_path", dict(required=True)),
        ("--match_list_path", dict(required=True)),
    ], device=False)
    add("point_triangulator", cmd_point_triangulator, [
        ("--database_path", dict(required=True)),
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
    ])
    add("model_analyzer", cmd_model_analyzer, [
        ("--input_path", dict(required=True)),
    ], device=False)
    add("model_merger", cmd_model_merger, [
        ("--input_path1", dict(required=True)),
        ("--input_path2", dict(required=True)),
        ("--output_path", dict(required=True)),
    ])
    add("model_aligner", cmd_model_aligner, [
        ("--input_path", dict(required=True)),
        ("--ref_images_path", dict(required=True)),
        ("--output_path", dict(required=True)),
    ], device=False)
    add("point_filtering", cmd_point_filtering, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--min_track_len", dict(type=int, default=2)),
        ("--max_reproj_error", dict(type=float, default=4.0)),
    ], device=False)
    add("database_merger", cmd_database_merger, [
        ("--database_path1", dict(required=True)),
        ("--database_path2", dict(required=True)),
        ("--merged_database_path", dict(required=True)),
    ], device=False)
    add("project_generator", cmd_project_generator, [
        ("--output_path", dict(required=True)),
        ("--quality", dict(default="high")),
    ], device=False)
    add("feature_importer", cmd_feature_importer, [
        ("--database_path", dict(required=True)),
        ("--import_path", dict(required=True)),
        ("--default_width", dict(type=int, default=1024)),
        ("--default_height", dict(type=int, default=768)),
    ], device=False)
    add("image_deleter", cmd_image_deleter, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--image_ids_path", dict(default="")),
        ("--image_names_path", dict(default="")),
    ], device=False)
    add("image_filterer", cmd_image_filterer, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--min_focal_length_ratio", dict(type=float, default=0.1)),
        ("--max_focal_length_ratio", dict(type=float, default=10.0)),
        ("--max_extra_param", dict(type=float, default=100.0)),
        ("--min_num_observations", dict(type=int, default=10)),
    ], device=False)
    add("image_registrator", cmd_image_registrator, [
        ("--database_path", dict(required=True)),
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
    ])
    add("rig_bundle_adjuster", cmd_rig_bundle_adjuster, [
        ("--input_path", dict(required=True)),
        ("--output_path", dict(required=True)),
        ("--rig_config_path", dict(required=True)),
        ("--max_num_iterations", dict(type=int, default=50)),
        ("--refine_relative_poses", dict(type=int, default=1)),
    ])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)
