"""DistributedMapperController: the whole graph-partitioned SfM pipeline.

Port of dagsfm_tpu/pipeline/distributed_mapper.py:

    verified matches -> view graph (two-view geometry per pair)
    -> triplet rotation-cycle filter (5 deg) + largest component
    -> global rotation averaging + orientation filter
    -> cut-and-expand clustering
    -> per-cluster incremental mapping, biggest cluster first
    -> minimum-spanning-tree Sim(3) merge (SfMAligner)
    -> separator retriangulation (optional)
    -> final global BA with track selection

Every stage runs on the controller's device (the GPU unless "cpu" is
asked for). Clusters may run in threads (`reconstruct_partitions(
num_threads)`), or in worker processes that claim the jobs of
`export_cluster_jobs` (parallel/distributed.py) and whose partitions
`run(checkpoint_path)` merges. With `distributed_final_ba` the final BA
cuts the points into `num_devices` shards (default: one per rank of the
process group) and solves them with parallel/ba_sharded.py; as in the
reference, that solve ignores the track selection.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.clustering.image_clustering import (ClusteringOptions,
                                                          ImageClustering)
from dagsfm_tpu_torch.estimation import rotation_averaging as ra
from dagsfm_tpu_torch.graph.view_graph import TwoViewEdge, ViewGraph
from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.ops import two_view_classify as tvc
from dagsfm_tpu_torch.parallel import ba_sharded
from dagsfm_tpu_torch.parallel.distributed import (cluster_inputs,
                                                   run_clusters_threaded)
from dagsfm_tpu_torch.parallel.mesh import process_group
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene import io as scene_io
from dagsfm_tpu_torch.scene.reconstruction import Reconstruction
from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
from dagsfm_tpu_torch.sfm.aligner import AlignerOptions, SfMAligner
from dagsfm_tpu_torch.sfm.correspondence_graph import CorrespondenceGraph
from dagsfm_tpu_torch.sfm.incremental_mapper import (IncrementalMapper,
                                                     MapperOptions)
from dagsfm_tpu_torch.sfm.track_selection import (TrackSelectionOptions,
                                                  select_tracks)
from dagsfm_tpu_torch.utils import observability as obs


def _stage(key: str):
    """A pipeline stage: its method runs in the span `mapper.<key>`, whose
    seconds become `timings[key]`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(self, *args, **kwargs):
            with obs.span("mapper." + key) as s:
                out = fn(self, *args, **kwargs)
            self.timings[key] = s.seconds
            return out
        return run
    return wrap


@dataclasses.dataclass
class DistributedMapperOptions:
    clustering: ClusteringOptions = dataclasses.field(
        default_factory=ClusteringOptions)
    mapper: MapperOptions = dataclasses.field(default_factory=MapperOptions)
    ra_options: ra.RAOptions = dataclasses.field(default_factory=ra.RAOptions)
    track_selection: TrackSelectionOptions = dataclasses.field(
        default_factory=TrackSelectionOptions)
    aligner: AlignerOptions = dataclasses.field(default_factory=AlignerOptions)
    min_num_matches: int = 16
    rotation_filter_max_deg: float = 5.0
    select_tracks_for_bundle_adjustment: bool = True
    final_ba: bool = True
    retriangulate: bool = False
    final_ba_iterations: int = 50
    distributed_final_ba: bool = False    # shard the final BA
    num_devices: int | None = None        # its shards; None: the ranks
    seed: int = 0


class DistributedMapperController:
    """Runs the pipeline on (cameras, images, verified match graph).

    `two_view_geometries` ({(i, j): (R, t, num_inliers, config)}, e.g.
    `FeaturePipeline.two_view_edges()`) gives the view graph's edges as
    the matching stage verified them; without it they are estimated from
    the match graph."""

    def __init__(self, cameras: dict, images: dict,
                 graph: CorrespondenceGraph,
                 options: DistributedMapperOptions | None = None,
                 two_view_geometries: dict | None = None, device=None):
        self.cameras = cameras
        self.images = images
        self.graph = graph
        self.two_view_geometries = two_view_geometries
        self.opts = options or DistributedMapperOptions()
        self.device = devmod.resolve(device)
        self.view_graph = ViewGraph()
        # edges of the view graph as built and after each filter
        self.view_graph_edges: dict = {}
        self.global_rotations: dict = {}
        self.clusters = []
        self.clustering_summary: dict = {}
        self.local_recons: list = []
        self.local_reg_images: list = []
        self.separators: list = []
        self.timings: dict = {}
        self.ba_stats = None

    # -------------------------------------------------- 1. view graph
    def _add_edge(self, i, j, R, t, num_inliers, config) -> None:
        if R is None or num_inliers < self.opts.min_num_matches:
            return
        if config in (tvc.DEGENERATE, tvc.WATERMARK):
            return
        self.view_graph.add_edge(TwoViewEdge(i, j, np.asarray(R),
                                             np.asarray(t), num_inliers))

    def _built(self) -> ViewGraph:
        self.view_graph_edges["built"] = self.view_graph.num_edges()
        return self.view_graph

    @_stage("view_graph")
    def build_view_graph(self) -> ViewGraph:
        """One relative-pose edge per verified pair: from
        `two_view_geometries` when given, else from E/F/H classification
        of the match graph's pairs (calibrated pairs through E, the others
        through F or H; watermarks and degenerate pairs dropped)."""
        if self.two_view_geometries is not None:
            for (i, j), (R, t, ninl, config) in \
                    self.two_view_geometries.items():
                self._add_edge(i, j, R, t, ninl, config)
            return self._built()

        cam_of = {i: self.cameras[im.camera_id]
                  for i, im in self.images.items()}
        pair_data = []
        for (i, j) in self.graph.image_pairs():
            m = self.graph.matches_between(i, j)
            if len(m) < self.opts.min_num_matches:
                continue
            ci, cj = cam_of[i], cam_of[j]
            pair_data.append((
                (i, j), self.images[i].xys[m[:, 0]],
                self.images[j].xys[m[:, 1]],
                ci.calibration_matrix(), cj.calibration_matrix(),
                (ci.width, ci.height), (cj.width, cj.height),
                ci.prior_focal and cj.prior_focal))
        tv_opts = tvc.TwoViewOptions(
            min_num_inliers=self.opts.min_num_matches,
            max_error_px=self.opts.mapper.abs_pose_max_error_px / 3.0,
            num_hypotheses=self.opts.mapper.num_ransac_hypotheses)
        results = tvc.classify_pairs(pair_data, tv_opts, seed=self.opts.seed,
                                     device=self.device)
        for (i, j), res in results.items():
            self._add_edge(i, j, res.R, res.t, res.num_inliers, res.config)
        return self._built()

    # -------------------------------------- 2. filters + rotation averaging
    @_stage("rotation_averaging")
    def filter_and_average_rotations(self):
        self.view_graph.filter_cycles_by_rotation(
            self.opts.rotation_filter_max_deg, device=self.device)
        self.view_graph_edges["cycles"] = self.view_graph.num_edges()
        cc = self.view_graph.largest_connected_component()
        self.view_graph = self.view_graph.subgraph(cc)
        self.view_graph_edges["component"] = self.view_graph.num_edges()

        ids = sorted(self.view_graph.nodes)
        index = {v: k for k, v in enumerate(ids)}
        edges = np.array([(index[i], index[j])
                          for (i, j) in self.view_graph.edges], np.int64)
        rels = np.stack([e.rotation
                         for e in self.view_graph.edges.values()])
        R_glob = ra.estimate_rotations(len(ids), edges, rels,
                                       self.opts.ra_options,
                                       device=self.device)
        keep = ra.filter_pairs_from_orientation(
            edges, rels, R_glob, self.opts.rotation_filter_max_deg,
            device=self.device)
        self.view_graph.edges = {k: e for (k, e), ok in
                                 zip(self.view_graph.edges.items(), keep)
                                 if ok}
        self.view_graph_edges["orientation"] = self.view_graph.num_edges()
        cc = self.view_graph.largest_connected_component()
        self.view_graph = self.view_graph.subgraph(cc)
        self.view_graph_edges["final"] = self.view_graph.num_edges()
        self.global_rotations = {v: R_glob[index[v]] for v in cc}

    # ------------------------------------------------ 3. clustering
    @_stage("clustering")
    def cluster_scenes(self):
        edges = {k: e.num_inliers for k, e in self.view_graph.edges.items()}
        ic = ImageClustering(sorted(self.view_graph.nodes), edges,
                             self.opts.clustering, device=self.device)
        ic.cut()
        self.clusters = ic.expand()
        self.clustering_summary = ic.summary
        return self.clusters

    # ------------------------------------- 4. per-cluster reconstruction
    def _reconstruct_one_cluster(self, cluster):
        sub_images, sub_graph = cluster_inputs(self.images, self.graph,
                                               cluster.image_ids)
        # every cluster starts from the shared cameras: a mapper writes
        # refined intrinsics into its own model only
        rec = IncrementalMapper(self.cameras, sub_images, sub_graph,
                                self.opts.mapper,
                                device=self.device).reconstruct()
        for im in rec.images.values():
            im.cluster_id = cluster.cluster_id
        return rec

    @_stage("reconstruction")
    def reconstruct_partitions(self, num_threads: int = 1):
        """Incremental SfM per cluster, biggest cluster first (a stable
        sort by size); with num_threads > 1 on a pool of threads, which
        gives the same models."""
        order = sorted(range(len(self.clusters)),
                       key=lambda c: -len(self.clusters[c].image_ids))
        jobs = [self.clusters[c] for c in order]
        if num_threads > 1:
            recs = run_clusters_threaded(jobs, self._reconstruct_one_cluster,
                                         max_workers=num_threads)
        else:
            recs = [self._reconstruct_one_cluster(c) for c in jobs]
        self.local_recons = [r for r in recs if r.num_reg_images() >= 2]
        # registered images per local model (the merge grows the anchor's)
        self.local_reg_images = [r.num_reg_images() for r in recs]
        return self.local_recons

    # ------------------------------------------------ 5. merge
    @_stage("merge")
    def merge_clusters(self) -> Reconstruction:
        aligner = SfMAligner(self.local_recons, self.opts.aligner,
                             device=self.device)
        merged = aligner.align()
        self.separators = aligner.separator_image_ids(merged)
        return merged

    # ---------------------------------------- 6. retriangulate + final BA
    @_stage("retriangulation")
    def retriangulate(self, merged: Reconstruction):
        """Triangulate the separator images again on the merged model, then
        extend and fuse the tracks that the merge left split in two."""
        mapper = IncrementalMapper.wrap(self.cameras, merged, self.graph,
                                        self.opts.mapper, device=self.device)
        for i in self.separators:
            mapper.triangulate_image(i)
        sep_pts = set()
        for i in self.separators:
            sep_pts.update(int(p) for p in merged.images[i].point3D_ids
                           if p >= 0)
        mapper.complete_tracks(sorted(sep_pts))
        mapper.merge_tracks(sep_pts)
        mapper.filter_points()

    @_stage("final_ba")
    def adjust_global_bundle(self, merged: Reconstruction):
        """Final BA: the first two images pinned, Cauchy loss of scale 1
        px, final_ba_iterations LM steps. In one process the selected
        tracks are free and the others held constant (and the loop may
        stop early); sharded, every track is free and every iteration
        runs, as in the reference."""
        opts = ba.BAOptions(max_iterations=self.opts.final_ba_iterations,
                            loss="cauchy", loss_scale=1.0)
        select = self.opts.select_tracks_for_bundle_adjustment and \
            not self.opts.distributed_final_ba
        if select:
            sel = select_tracks(merged, self.opts.track_selection)
        arrays, ids = merged.to_arrays(self.device)
        const_image = np.zeros(len(ids[1]), bool)
        const_image[:2] = True
        if self.opts.distributed_final_ba:
            D = self.opts.num_devices or process_group()[2]
            prob, shard_pts = ba_sharded.shard_problem(
                arrays, D, const_image=const_image, device=self.device)
            prob, self.ba_stats = ba_sharded.solve_sharded(prob, opts)
            points = torch.as_tensor(ba_sharded.gather_points(
                prob, shard_pts, len(ids[2])), device=self.device)
        else:
            const_points = None
            if select:
                const_points = np.array([p not in sel for p in ids[2]],
                                        bool)
            prob = ba.make_problem(arrays, const_image=const_image,
                                   const_points=const_points)
            prob, self.ba_stats = ba.solve(prob, opts)
            points = prob.points
        merged.update_from_arrays(arrays._replace(
            image_qvec=prob.image_qvec, image_tvec=prob.image_tvec,
            points_xyz=points), ids)

    def separator_rmse(self, merged: Reconstruction) -> float:
        """Reprojection RMSE (px) over the separator images' observations
        in front of their cameras, through each camera's full model."""
        sepset = set(self.separators)
        by_cam: dict[int, list] = {}   # camera_id -> [(Xc, xy)]
        for pt in merged.points3D.values():
            for (i, kp) in pt.track:
                if i not in sepset:
                    continue
                im = merged.images[i]
                Xc = rops.quat_to_rotmat_np(im.qvec) @ pt.xyz + im.tvec
                if Xc[2] <= 1e-6:
                    continue
                by_cam.setdefault(im.camera_id, []).append((Xc, im.xys[kp]))
        errs = []
        for cid, rows in by_cam.items():
            cam = self.cameras[cid]
            Xc = torch.as_tensor(np.stack([r[0] for r in rows]))
            xy = np.stack([r[1] for r in rows])
            par = cm.pad_params(torch.as_tensor(cam.params, dtype=Xc.dtype),
                                cam.model_id)
            uv = cm.img_from_cam(cam.model_id, par, Xc).numpy()
            errs.append(np.sum((uv - xy) ** 2, axis=-1))
        if not errs:
            return 0.0
        return float(np.sqrt(np.mean(np.concatenate(errs))))

    # -------------------------------------------- checkpoint / resume
    def export_partitions(self, path: str):
        """Write each local model to path/partition<k>/."""
        for k, rec in enumerate(self.local_recons):
            scene_io.write_model_bin(rec, os.path.join(path, f"partition{k}"))

    def export_cluster_jobs(self, path: str):
        """Write path/clusters.json: one job per cluster (its id and image
        ids), for workers outside this process."""
        os.makedirs(path, exist_ok=True)
        jobs = [{"cluster_id": c.cluster_id,
                 "image_ids": [int(i) for i in c.image_ids]}
                for c in self.clusters]
        with open(os.path.join(path, "clusters.json"), "w") as f:
            json.dump(jobs, f)

    @staticmethod
    def partitions_exist(path: str) -> bool:
        return os.path.exists(os.path.join(path, "partition0", "cameras.bin"))

    def load_partitions(self, path: str):
        self.local_recons = []
        k = 0
        while os.path.exists(os.path.join(path, f"partition{k}",
                                          "cameras.bin")):
            self.local_recons.append(scene_io.read_model_bin(
                os.path.join(path, f"partition{k}")))
            k += 1
        return self.local_recons

    # ------------------------------------------------------------- run
    def run(self, checkpoint_path: str | None = None) -> Reconstruction:
        """The whole pipeline. With checkpoint_path the local models are
        exported there, and partitions already there skip straight to the
        merge."""
        with obs.span("mapper.run") as total:
            if checkpoint_path and self.partitions_exist(checkpoint_path):
                self.load_partitions(checkpoint_path)
            else:
                self.build_view_graph()
                self.filter_and_average_rotations()
                self.cluster_scenes()
                self.reconstruct_partitions()
                if checkpoint_path:
                    self.export_partitions(checkpoint_path)
            if not self.local_recons:
                return Reconstruction()
            merged = self.merge_clusters()
            if self.opts.retriangulate:
                self.retriangulate(merged)
            if self.opts.final_ba:
                self.adjust_global_bundle(merged)
        self.timings["total"] = total.seconds
        return merged

    def report(self) -> str:
        """Per-stage wall-clock seconds."""
        lines = ["Timings:"]
        for k, v in self.timings.items():
            lines.append(f"  {k:>20s}: {v:8.3f}s")
        return "\n".join(lines)
