"""Carry the JAX package's state into the port's containers.

The JAX side hands over plain data: `SceneArrays._asdict()` with numpy
values, a Reconstruction's cameras / images / points as dicts of records
(any objects with the reference's field names), descriptor / mask
dicts, view graphs, image clusters and camera rigs (objects with the
reference's field names), vocab trees (levels, proj, thresholds as
arrays), problems and options as plain dicts (`NamedTuple._asdict()`,
`dataclasses.asdict`) and SIFT outputs as numpy arrays. Nothing here
imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.clustering.image_clustering import (ClusteringOptions,
                                                          ImageCluster)
from dagsfm_tpu_torch.clustering.scene_clustering import \
    SceneClusteringOptions
from dagsfm_tpu_torch.estimation.coordinate_frame import ManhattanOptions
from dagsfm_tpu_torch.estimation.rotation_averaging import RAOptions
from dagsfm_tpu_torch.features import retrieval as rt
from dagsfm_tpu_torch.features import sift
from dagsfm_tpu_torch.features import visual_index as vi
from dagsfm_tpu_torch.features.matching import (DescriptorBank,
                                                MatchingOptions, make_bank)
from dagsfm_tpu_torch.graph.view_graph import TwoViewEdge, ViewGraph
from dagsfm_tpu_torch.mvs import controller as mvs_controller
from dagsfm_tpu_torch.mvs import fusion as mvs_fusion
from dagsfm_tpu_torch.mvs import meshing as mvs_meshing
from dagsfm_tpu_torch.mvs import patch_match as mvs_pm
from dagsfm_tpu_torch.mvs import poisson as mvs_poisson
from dagsfm_tpu_torch.ops import two_view_classify as tvc
from dagsfm_tpu_torch.ops.ransac_variants import SPRTOptions
from dagsfm_tpu_torch.parallel.ba_sharded import (ShardedBAProblem,
                                                  problem_from_numpy)
from dagsfm_tpu_torch.pipeline.distributed_mapper import \
    DistributedMapperOptions
from dagsfm_tpu_torch.pipeline.feature_pipeline import (
    FeaturePipelineOptions, TwoViewRecord)
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene.camera_rig import CameraRig
from dagsfm_tpu_torch.scene.image_reader import ImageReaderOptions
from dagsfm_tpu_torch.scene.reconstruction import (ImageRecord, Point3DRecord,
                                                   Reconstruction, SceneArrays,
                                                   scene_arrays_from_numpy)
from dagsfm_tpu_torch.scene.reconstruction_manager import \
    ReconstructionManager
from dagsfm_tpu_torch.scene.undistortion import UndistortOptions
from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
from dagsfm_tpu_torch.sfm import rig_bundle_adjustment as rba
from dagsfm_tpu_torch.sfm.aligner import AlignerOptions
from dagsfm_tpu_torch.sfm.incremental_mapper import MapperOptions
from dagsfm_tpu_torch.sfm.mapper_controller import ControllerOptions
from dagsfm_tpu_torch.sfm.track_selection import TrackSelectionOptions
from dagsfm_tpu_torch.solvers.admm import ADMMOptions
from dagsfm_tpu_torch.utils.options import ProjectOptions


def scene_arrays(fields: dict, device=None) -> SceneArrays:
    """SceneArrays from the reference's `SceneArrays._asdict()`."""
    return scene_arrays_from_numpy(
        {k: np.asarray(v) for k, v in fields.items()}, devmod.resolve(device))


def ba_problem(fields: dict, device=None) -> ba.BAProblem:
    """Port BAProblem from the reference's `BAProblem._asdict()`: its
    live observations (obs_mask) with the same poses, cameras of any
    model, points, pinned images and points and cam_refine mask."""
    dev = devmod.resolve(device)
    f = {k: np.array(v) for k, v in fields.items()}
    live = f["obs_mask"].astype(bool)
    return ba.problem_from_observations(
        f["image_qvec"], f["image_tvec"], f["image_camidx"],
        f["cam_model_id"], f["cam_params"], f["points"],
        f["obs_image"][live], f["obs_point"][live], f["obs_xy"][live],
        f["const_image"], f["const_points"], f["cam_refine"], device=dev)


def sharded_problem(fields: dict, device=None) -> ShardedBAProblem:
    """Port ShardedBAProblem from the reference's
    `ShardedBAProblem._asdict()` (the same shards, arrays and dtypes)."""
    return problem_from_numpy(fields, devmod.resolve(device))


def camera(c) -> cm.Camera:
    """Port Camera of any model from the reference's (prior_focal kept)."""
    return cm.Camera(int(c.camera_id), int(c.model_id), int(c.width),
                     int(c.height), tuple(float(p) for p in c.params),
                     prior_focal=bool(getattr(c, "prior_focal", True)))


def image_record(im) -> ImageRecord:
    return ImageRecord(
        image_id=int(im.image_id), name=str(im.name),
        camera_id=int(im.camera_id),
        qvec=np.asarray(im.qvec, np.float64).copy(),
        tvec=np.asarray(im.tvec, np.float64).copy(),
        xys=np.asarray(im.xys, np.float64).copy(),
        point3D_ids=np.asarray(im.point3D_ids, np.int64).copy(),
        registered=bool(im.registered),
        cluster_id=int(getattr(im, "cluster_id", -1)))


def reconstruction(cameras: dict, images: dict, points3D: dict,
                   next_point3D_id: int | None = None) -> Reconstruction:
    """Port Reconstruction from the reference's cameras / images /
    points3D dicts (same ids, same point order)."""
    rec = Reconstruction()
    for cid in cameras:
        rec.add_camera(camera(cameras[cid]))
    for iid in images:
        rec.add_image(image_record(images[iid]))
    for pid, pt in points3D.items():
        rec.points3D[int(pid)] = Point3DRecord(
            np.asarray(pt.xyz, np.float64).copy(),
            np.asarray(pt.color, np.uint8).copy(), float(pt.error),
            [(int(i), int(k)) for (i, k) in pt.track])
    rec._next_point3D_id = (next_point3D_id if next_point3D_id is not None
                            else max(rec.points3D, default=0) + 1)
    return rec


def reconstruction_manager(mgr) -> ReconstructionManager:
    """Port ReconstructionManager from the reference's: each model carried
    over by `reconstruction`, in the same order."""
    out = ReconstructionManager()
    for rec in mgr:
        out.add(reconstruction(rec.cameras, rec.images, rec.points3D,
                               rec._next_point3D_id))
    return out


def _array(x, dtype=np.float64):
    return None if x is None else np.array(x, dtype)


def two_view_records(records: dict) -> dict:
    """Port TwoViewRecords from the reference pipeline's `two_view` dict
    (the same pairs in the same order)."""
    return {(int(i), int(j)): TwoViewRecord(
        _array(r.R), _array(r.t), np.array(r.inlier_matches, np.uint32),
        int(r.num_inliers), int(r.config), E=_array(r.E), F=_array(r.F),
        H=_array(r.H)) for (i, j), r in records.items()}


def descriptor_bank(descriptors: dict, masks: dict,
                    image_ids: list | None = None,
                    device=None) -> DescriptorBank:
    """bf16 DescriptorBank from image_id -> (K, 128) / (K,) dicts."""
    return make_bank({i: np.asarray(d, np.float32)
                      for i, d in descriptors.items()},
                     {i: np.asarray(m, bool) for i, m in masks.items()},
                     image_ids, device=device)


# options of the reference's SIFT that select one of its TPU sampling
# routes; the port has one route (gathers), so they carry no meaning here
_SIFT_ROUTE_KEYS = ("patch_sampling", "patch_chunk")


def sift_options(fields: dict) -> sift.SiftOptions:
    """SiftOptions from the reference's `SiftOptions._asdict()`."""
    return sift.SiftOptions(**{k: v for k, v in fields.items()
                               if k not in _SIFT_ROUTE_KEYS})


def two_view_options(fields: dict) -> tvc.TwoViewOptions:
    """TwoViewOptions from the reference's `dataclasses.asdict(...)`."""
    return tvc.TwoViewOptions(**fields)


def sift_features(fields: dict, device=None) -> sift.SiftFeatures:
    """SiftFeatures from numpy arrays under the reference's field names."""
    dev = devmod.resolve(device)
    return sift.SiftFeatures(**{
        k: devmod.as_tensor(np.asarray(v), dev,
                            dtype=None if k in ("mask", "score") else
                            devmod.DTYPE)
        for k, v in fields.items()})


def to_numpy(result):
    """A tuple of tensors (e.g. `two_view_classify._efh_batched`'s
    outputs) as a tuple of numpy arrays; numpy and None pass through."""
    return tuple(r.detach().cpu().numpy() if hasattr(r, "detach") else r
                 for r in result)


def view_graph(vg) -> ViewGraph:
    """Port ViewGraph from the reference's: the same nodes, and the same
    edges (R, t, inlier counts) in the same order."""
    out = ViewGraph()
    out.nodes = {int(v) for v in vg.nodes}
    for (i, j), e in vg.edges.items():
        out.edges[(int(i), int(j))] = TwoViewEdge(
            int(e.image_id1), int(e.image_id2),
            np.array(e.rotation, np.float64), np.array(e.position, np.float64),
            int(e.num_inliers), float(e.visibility_score))
    return out


def image_clusters(clusters) -> list:
    """Port ImageClusters from the reference's, in the same order."""
    return [ImageCluster(int(c.cluster_id), [int(i) for i in c.image_ids],
                         {(int(i), int(j)): float(w)
                          for (i, j), w in c.edges.items()})
            for c in clusters]


def _plain(v) -> dict:
    if hasattr(v, "_asdict"):
        return v._asdict()
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    return dict(v)


def controller_options(fields: dict) -> ControllerOptions:
    """ControllerOptions from the reference's `dataclasses.asdict(...)`
    (the mapper's options, snapshots included, as a dict or dataclass)."""
    f = dict(fields)
    if "mapper" in f:
        f["mapper"] = MapperOptions(**_plain(f["mapper"]))
    return ControllerOptions(**f)


def distributed_mapper_options(fields: dict) -> DistributedMapperOptions:
    """DistributedMapperOptions from the reference's
    `dataclasses.asdict(...)` (nested options as dicts or NamedTuples).
    `num_devices` stays the sharded final BA's number of shards."""
    f = dict(fields)
    nested = {"clustering": ClusteringOptions, "ra_options": RAOptions,
              "track_selection": TrackSelectionOptions,
              "aligner": AlignerOptions, "mapper": MapperOptions}
    for k, cls in nested.items():
        if k in f:
            f[k] = cls(**_plain(f[k]))
    return DistributedMapperOptions(**f)


def retrieval_options(fields: dict) -> rt.RetrievalOptions:
    """RetrievalOptions from the reference's `RetrievalOptions._asdict()`."""
    return rt.RetrievalOptions(**fields)


def vocab_tree_options(fields: dict) -> vi.VocabTreeOptions:
    """VocabTreeOptions from the reference's `VocabTreeOptions._asdict()`."""
    return vi.VocabTreeOptions(**fields)


def vocab_tree(tree, device=None) -> vi.VocabTree:
    """Port VocabTree from the reference's (levels, proj and thresholds as
    arrays), in float32 on `device`."""
    return vi.tree_from_arrays([np.asarray(lv) for lv in tree.levels],
                               np.asarray(tree.proj),
                               np.asarray(tree.thresholds), device)


def feature_pipeline_options(fields: dict) -> FeaturePipelineOptions:
    """FeaturePipelineOptions from the reference's
    `dataclasses.asdict(...)` (its SIFT, matching and retrieval options as
    dicts or NamedTuples)."""
    f = dict(fields)
    if "sift" in f:
        f["sift"] = sift_options(_plain(f["sift"]))
    if "matching" in f:
        f["matching"] = MatchingOptions(**_plain(f["matching"]))
    if "retrieval" in f:
        f["retrieval"] = retrieval_options(_plain(f["retrieval"]))
    return FeaturePipelineOptions(**f)


def patch_match_options(fields: dict) -> mvs_pm.PatchMatchOptions:
    """PatchMatchOptions from the reference's `PatchMatchOptions._asdict()`."""
    return mvs_pm.PatchMatchOptions(**fields)


def fusion_options(fields: dict) -> mvs_fusion.FusionOptions:
    """FusionOptions from the reference's `FusionOptions._asdict()`."""
    return mvs_fusion.FusionOptions(**fields)


def dense_options(fields: dict) -> mvs_controller.DenseOptions:
    """DenseOptions from the reference's `DenseOptions._asdict()` (its
    PatchMatch and fusion options as dicts or NamedTuples)."""
    f = dict(fields)
    if "patch_match" in f:
        f["patch_match"] = patch_match_options(_plain(f["patch_match"]))
    if "fusion" in f:
        f["fusion"] = fusion_options(_plain(f["fusion"]))
    return mvs_controller.DenseOptions(**f)


def poisson_options(fields: dict) -> mvs_poisson.PoissonOptions:
    """PoissonOptions from the reference's `PoissonOptions._asdict()`."""
    return mvs_poisson.PoissonOptions(**fields)


def meshing_options(fields: dict) -> mvs_meshing.MeshingOptions:
    """MeshingOptions from the reference's `MeshingOptions._asdict()`."""
    return mvs_meshing.MeshingOptions(**fields)


def undistort_options(fields: dict) -> UndistortOptions:
    """UndistortOptions from the reference's `dataclasses.asdict(...)`."""
    return UndistortOptions(**fields)


def rig_ba_problem(fields: dict, device=None) -> rba.RigBAProblem:
    """Port RigBAProblem from the reference's `RigBAProblem._asdict()`:
    int64 indices, float64 values on `device`."""
    dev = devmod.resolve(device)
    out = {}
    for k, v in fields.items():
        a = np.asarray(v)
        out[k] = (torch.as_tensor(a.astype(np.int64), device=dev)
                  if a.dtype.kind in "iu" else devmod.as_tensor(a, dev))
    return rba.RigBAProblem(**out)


def rig_ba_options(fields: dict) -> rba.RigBAOptions:
    """RigBAOptions from the reference's `RigBAOptions._asdict()`."""
    return rba.RigBAOptions(**fields)


def camera_rig(rig) -> CameraRig:
    """Port CameraRig from the reference's (mounts, snapshots and the
    reference camera, ids as ints)."""
    out = CameraRig(ref_camera_id=(None if rig.ref_camera_id is None
                                   else int(rig.ref_camera_id)))
    for cid in rig.cam_from_rig_q:
        out.add_camera(int(cid), np.array(rig.cam_from_rig_q[cid], float),
                       np.array(rig.cam_from_rig_t[cid], float))
    for snap in rig.snapshots:
        out.add_snapshot([int(i) for i in snap])
    return out


def project_options(opts) -> ProjectOptions:
    """Port ProjectOptions from the reference's (a dataclass or
    `dataclasses.asdict(...)`)."""
    f = _plain(opts)
    return ProjectOptions(
        **{k: v for k, v in f.items()
           if k not in ("clustering", "mapper", "track_selection")},
        clustering=ClusteringOptions(**_plain(f["clustering"])),
        mapper=MapperOptions(**_plain(f["mapper"])),
        track_selection=TrackSelectionOptions(
            **_plain(f["track_selection"])))


def image_reader_options(opts) -> ImageReaderOptions:
    """ImageReaderOptions from the reference's (a dataclass or a dict)."""
    return ImageReaderOptions(**_plain(opts))


def manhattan_options(opts) -> ManhattanOptions:
    """ManhattanOptions from the reference's (a dataclass or a dict)."""
    return ManhattanOptions(**_plain(opts))


def scene_clustering_options(opts) -> SceneClusteringOptions:
    """SceneClusteringOptions from the reference's (a dataclass or a
    dict)."""
    return SceneClusteringOptions(**_plain(opts))


def admm_options(opts) -> ADMMOptions:
    """ADMMOptions from the reference's (a NamedTuple or a dict)."""
    return ADMMOptions(**_plain(opts))


def sprt_options(opts) -> SPRTOptions:
    """SPRTOptions from the reference's (a NamedTuple or a dict)."""
    return SPRTOptions(**_plain(opts))
