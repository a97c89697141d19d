"""Feature pipeline controller: images -> SIFT -> pairs -> matches ->
verification (+ guided re-matching) -> mapper inputs.

Port of dagsfm_tpu/pipeline/feature_pipeline.py: `extract_features`
(SIFT per image batch on the device, the bf16 descriptor bank kept there),
exhaustive pairs, `match_and_verify` with full E/F/H classification and
optional guided matching, `to_mapper_inputs`, `two_view_edges`. Other
pair modes and the SQLite database wait.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.features import matching as fm
from dagsfm_tpu_torch.features import retrieval as rt
from dagsfm_tpu_torch.features import sift
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
    sift: sift.SiftOptions = dataclasses.field(default_factory=sift.SiftOptions)
    matching: fm.MatchingOptions = dataclasses.field(
        default_factory=fm.MatchingOptions)
    pair_mode: str = "exhaustive"
    batch_size: int = 8             # images per SIFT call
    min_num_inliers: int = 15
    max_error_px: float = 4.0
    num_ransac_hypotheses: int = 256
    two_view_essential_only: bool = False
    seed: int = 0
    guided_matching: bool = False


class FeaturePipeline:
    """Extract + match + verify for a set of images.

    images: dict image_id -> (H, W) float32 grayscale array in [0, 1], all
    of one size; cameras: dict image_id -> Camera. `device` is where
    extraction, matching and verification run: the GPU unless "cpu" is
    asked for.
    """

    def __init__(self, images: dict, cameras: dict,
                 options: FeaturePipelineOptions | None = None,
                 device=None):
        self.images = images
        self.cameras = cameras
        self.opts = options or FeaturePipelineOptions()
        self.device = devmod.resolve(device)
        self.keypoints: dict = {}
        self.kp_geom: dict = {}     # image_id -> (K, 4) x y scale ori
        self.descriptors: dict = {}
        self.masks: dict = {}
        self.matches: dict = {}
        self.two_view: dict = {}
        self.timings: dict = {}
        self.num_classified = 0     # pairs that entered verification
        self.bank: fm.DescriptorBank | None = None
        self._dev_feats: dict = {}

    def extract_features(self):
        """SIFT for every image, `batch_size` images per call (the last
        batch padded with its last image). Images larger than
        `sift.max_image_size` are shrunk for extraction as the reference
        shrinks them (`jax.image.resize` linear, antialiased; see
        `sift.resize_linear`) and the keypoints mapped back. Host copies:
        keypoints and kp_geom float64, descriptors float32, masks; the bf16
        bank stays on the device."""
        t0 = time.time()
        ids = sorted(self.images)
        B = self.opts.batch_size
        H, W = next(iter(self.images.values())).shape
        max_dim = max(H, W)
        bound = self.opts.sift.max_image_size
        scale_back = 1.0
        if bound > 0 and max_dim > bound:
            scale = bound / max_dim
            newH, newW = int(round(H * scale)), int(round(W * scale))
            scale_back = max_dim / bound
        keep_bank = len(ids) * self.opts.sift.max_num_features * 128 * 2 \
            < 4 * 1024 ** 3
        bank_ids, bank_desc, bank_mask = [], [], []
        for s in range(0, len(ids), B):
            chunk = ids[s: s + B]
            real = len(chunk)
            chunk = chunk + [chunk[-1]] * (B - real)
            batch = torch.as_tensor(
                np.stack([self.images[i] for i in chunk]),
                dtype=torch.float32).to(self.device)
            if scale_back != 1.0:
                batch = sift.resize_linear(batch, newH, newW)
            feats = sift.extract(batch, self.opts.sift)
            if keep_bank:
                bank_ids.extend(chunk[:real])
                bank_desc.append(feats.descriptor[:real].float()
                                 .to(torch.bfloat16))
                bank_mask.append(feats.mask[:real])
            xy = feats.xy[:real].cpu().numpy() * scale_back
            desc = feats.descriptor[:real].float().cpu().numpy()
            mask = feats.mask[:real].cpu().numpy()
            scl = feats.scale[:real].cpu().numpy() * scale_back
            ori = feats.orientation[:real].cpu().numpy()
            for k, i in enumerate(chunk[:real]):
                self.keypoints[i] = xy[k]
                self.kp_geom[i] = np.concatenate(
                    [xy[k], scl[k][:, None], ori[k][:, None]], axis=1)
                self.descriptors[i] = desc[k]
                self.masks[i] = mask[k]
        if bank_ids:
            self.bank = fm.make_bank_from_device(
                bank_ids, torch.cat(bank_desc), torch.cat(bank_mask))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["extraction"] = time.time() - t0

    def select_pairs(self) -> list:
        if self.opts.pair_mode != "exhaustive":
            raise NotImplementedError(
                f"pair_mode {self.opts.pair_mode!r} is not ported")
        return [(i, j) for (i, j, _) in rt.exhaustive_pairs(
            sorted(self.images))]

    def match_and_verify(self, pairs: list | None = None):
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
        t_guided = 0.0
        for (i, j), res in results.items():
            if res.config in (tvc.DEGENERATE, tvc.WATERMARK):
                continue
            if res.num_inliers < self.opts.min_num_inliers:
                continue
            m = raw[(i, j)]
            inlier_matches = m[res.inlier_mask]
            num_inliers = res.num_inliers
            if self.opts.guided_matching:
                tg = time.time()
                gm = self._guided_rematch((i, j), res)
                t_guided += time.time() - tg
                if gm is not None and len(gm) >= num_inliers:
                    inlier_matches, num_inliers = gm, len(gm)
            self.matches[(i, j)] = m
            self.two_view[(i, j)] = TwoViewRecord(
                R=res.R, t=res.t, inlier_matches=inlier_matches,
                num_inliers=num_inliers, config=res.config,
                E=res.E, F=res.F, H=res.H)
        self.timings["verification"] = time.time() - t0
        self.num_classified = len(pair_data)
        if self.opts.guided_matching:
            self.timings["guided_matching"] = t_guided  # within verification

    def _on_device(self, i):
        """Image i's f32 descriptors, f64 keypoints and mask on the device
        (uploaded once per image for guided matching)."""
        if i not in self._dev_feats:
            dev = self.device
            self._dev_feats[i] = (
                torch.as_tensor(self.descriptors[i], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(self.keypoints[i], dtype=torch.float64,
                                device=dev),
                torch.as_tensor(self.masks[i], dtype=torch.bool, device=dev))
        return self._dev_feats[i]

    def _guided_rematch(self, pair, res):
        """Guided matching under the winning two-view model: the epipolar
        constraint for E/F pairs, the homography transfer for H pairs.
        Returns (M, 2) uint32 or None."""
        i, j = pair
        use_h = res.config in (tvc.PLANAR, tvc.PANORAMIC,
                               tvc.PLANAR_OR_PANORAMIC)
        G = res.H if use_h else res.F
        if G is None:
            return None
        (d1, xy1, m1), (d2, xy2, m2) = self._on_device(i), self._on_device(j)
        matches, _ = fm.guided_match_pair(
            d1, d2, xy1, xy2, m1, m2,
            torch.as_tensor(np.asarray(G), dtype=torch.float64,
                            device=self.device),
            max_error_px=self.opts.max_error_px, opts=self.opts.matching,
            use_homography=use_h)
        m = matches.cpu().numpy()
        return m[m[:, 0] >= 0].astype(np.uint32)

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

    def two_view_edges(self) -> dict:
        """{(i, j): (R, t, num_inliers, config)}: each verified pair's pose
        from its winning two-view model, for the distributed mapper's view
        graph (`DistributedMapperController(two_view_geometries=...)`)."""
        return {(i, j): (rec.R, rec.t, rec.num_inliers, rec.config)
                for (i, j), rec in self.two_view.items()}
