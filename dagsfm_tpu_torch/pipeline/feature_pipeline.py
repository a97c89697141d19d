"""Feature pipeline controller: pairs -> matches -> verification -> mapper
inputs.

Port of dagsfm_tpu/pipeline/feature_pipeline.py from the point where
features are in hand: `keypoints`, `descriptors`, `masks` and the bf16
`bank` are filled as `extract_features` leaves them (SIFT extraction
waits for its own slice). Exhaustive pairs only; guided matching and
the SQLite database wait.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.features import matching as fm
from dagsfm_tpu_torch.features import retrieval as rt
from dagsfm_tpu_torch.ops import two_view_classify as tvc
from dagsfm_tpu_torch.scene.reconstruction import ImageRecord
from dagsfm_tpu_torch.sfm.correspondence_graph import CorrespondenceGraph


class TwoViewRecord:
    """Verified two-view geometry of one pair."""

    __slots__ = ("R", "t", "inlier_matches", "num_inliers", "config",
                 "E", "F", "H")

    def __init__(self, R, t, inlier_matches, num_inliers, config,
                 E=None, F=None, H=None):
        self.R = R
        self.t = t
        self.inlier_matches = inlier_matches
        self.num_inliers = num_inliers
        self.config = config
        self.E = E
        self.F = F
        self.H = H


@dataclasses.dataclass
class FeaturePipelineOptions:
    matching: fm.MatchingOptions = dataclasses.field(
        default_factory=fm.MatchingOptions)
    pair_mode: str = "exhaustive"
    min_num_inliers: int = 15
    max_error_px: float = 4.0
    num_ransac_hypotheses: int = 256
    two_view_essential_only: bool = False
    seed: int = 0
    guided_matching: bool = False


class FeaturePipeline:
    """Match + verify for a set of images.

    images: dict image_id -> image (only the ids are read in this slice);
    cameras: dict image_id -> Camera. `device` is where matching and
    verification run: the GPU unless "cpu" is asked for.
    """

    def __init__(self, images: dict, cameras: dict,
                 options: FeaturePipelineOptions | None = None,
                 device=None):
        self.images = images
        self.cameras = cameras
        self.opts = options or FeaturePipelineOptions()
        self.device = devmod.resolve(device)
        self.keypoints: dict = {}
        self.descriptors: dict = {}
        self.masks: dict = {}
        self.matches: dict = {}
        self.two_view: dict = {}
        self.timings: dict = {}
        self.bank: fm.DescriptorBank | None = None

    def select_pairs(self) -> list:
        if self.opts.pair_mode != "exhaustive":
            raise NotImplementedError(
                f"pair_mode {self.opts.pair_mode!r} is not ported")
        return [(i, j) for (i, j, _) in rt.exhaustive_pairs(
            sorted(self.images))]

    def match_and_verify(self, pairs: list | None = None):
        if self.opts.guided_matching:
            raise NotImplementedError("guided matching is not ported")
        t0 = time.time()
        if pairs is None:
            pairs = self.select_pairs()
            self.timings["pair_selection"] = time.time() - t0
        t0 = time.time()
        raw = fm.match_pairs(self.descriptors, self.masks, pairs,
                             self.opts.matching, bank=self.bank,
                             device=self.device)
        self.timings["matching"] = time.time() - t0

        t0 = time.time()
        pair_data = []
        for (i, j), m in raw.items():
            if len(m) < self.opts.min_num_inliers:
                continue
            cam_i, cam_j = self.cameras[i], self.cameras[j]
            pair_data.append((
                (i, j), self.keypoints[i][m[:, 0]], self.keypoints[j][m[:, 1]],
                cam_i.calibration_matrix(), cam_j.calibration_matrix(),
                (cam_i.width, cam_i.height), (cam_j.width, cam_j.height),
                cam_i.prior_focal and cam_j.prior_focal))
        tv_opts = tvc.TwoViewOptions(
            min_num_inliers=self.opts.min_num_inliers,
            max_error_px=self.opts.max_error_px,
            num_hypotheses=self.opts.num_ransac_hypotheses,
            essential_only=self.opts.two_view_essential_only)
        results = tvc.classify_pairs(pair_data, tv_opts, seed=self.opts.seed,
                                     device=self.device)
        for (i, j), res in results.items():
            if res.config in (tvc.DEGENERATE, tvc.WATERMARK):
                continue
            if res.num_inliers < self.opts.min_num_inliers:
                continue
            m = raw[(i, j)]
            self.matches[(i, j)] = m
            self.two_view[(i, j)] = TwoViewRecord(
                R=res.R, t=res.t, inlier_matches=m[res.inlier_mask],
                num_inliers=res.num_inliers, config=res.config,
                E=res.E, F=res.F, H=res.H)
        self.timings["verification"] = time.time() - t0

    def to_mapper_inputs(self):
        """(cameras, images, graph) for the incremental mapper."""
        graph = CorrespondenceGraph()
        images = {}
        cam_by_id = {}
        for i in sorted(self.images):
            kp = self.keypoints[i][self.masks[i]].astype(np.float64)
            graph.add_image(i, len(kp))
            cam = self.cameras[i]
            cam_by_id[cam.camera_id] = cam
            images[i] = ImageRecord(
                image_id=i, name=f"image{i:05d}.jpg", camera_id=cam.camera_id,
                qvec=np.array([1.0, 0, 0, 0]), tvec=np.zeros(3), xys=kp,
                point3D_ids=np.full(len(kp), -1, np.int64))
        for (i, j), rec in self.two_view.items():
            inl_m = rec.inlier_matches
            remap_i = np.cumsum(self.masks[i]) - 1
            remap_j = np.cumsum(self.masks[j]) - 1
            mm = np.stack([remap_i[inl_m[:, 0]], remap_j[inl_m[:, 1]]], 1)
            graph.add_matches(i, j, mm.astype(np.uint32))
        return cam_by_id, images, graph
