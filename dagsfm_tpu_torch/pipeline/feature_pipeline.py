"""Feature pipeline controller: images -> SIFT -> pairs -> matches ->
verification (+ guided re-matching) -> COLMAP database -> mapper inputs.

Port of dagsfm_tpu/pipeline/feature_pipeline.py: `extract_features`
(SIFT per image batch on the device, the bf16 descriptor bank kept there),
`select_pairs` in all five pair modes (exhaustive, sequential with BoW
loop detection, BoW retrieval, vocab tree with Hamming re-ranking and
spatial verification, global descriptors), `match_and_verify` with full
E/F/H classification and
optional guided matching, `to_mapper_inputs`, `two_view_edges`, and the
database checkpoint: `write_database`, `run` (which loads a database that
already holds two-view geometries instead of computing anything) and
`load_from_database`. The module functions read a database:
`load_two_view_geometries_from_database` (the distributed controller's
pose edges), `load_features_from_database` and `run_matcher_on_database`
(matching and verification of given pairs on a database of features).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.features import global_descriptor as gd
from dagsfm_tpu_torch.features import matching as fm
from dagsfm_tpu_torch.features import retrieval as rt
from dagsfm_tpu_torch.features import sift
from dagsfm_tpu_torch.features import visual_index as vi
from dagsfm_tpu_torch.ops import epipolar as epi
from dagsfm_tpu_torch.ops import two_view_classify as tvc
from dagsfm_tpu_torch.scene import io as scene_io
from dagsfm_tpu_torch.scene.reconstruction import ImageRecord
from dagsfm_tpu_torch.sfm.correspondence_graph import CorrespondenceGraph
from dagsfm_tpu_torch.sfm.two_view import verify_pairs
from dagsfm_tpu_torch.utils import observability as obs


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
    retrieval: rt.RetrievalOptions = dataclasses.field(
        default_factory=rt.RetrievalOptions)
    pair_mode: str = "exhaustive"   # exhaustive | sequential | retrieval
    #                               # | vocab_tree | global
    # sequential mode: each frame with its next sequential_overlap frames,
    # and BoW loop detection every loop_detection_period frames (0: off)
    sequential_overlap: int = 10
    loop_detection_period: int = 0
    loop_detection_num_images: int = 50
    batch_size: int = 8             # images per SIFT call
    min_num_inliers: int = 15
    max_error_px: float = 4.0
    num_ransac_hypotheses: int = 256
    two_view_essential_only: bool = False
    seed: int = 0
    guided_matching: bool = False
    # vocab_tree mode: Hamming re-rank depth and vote-and-verify
    vocab_tree_rerank: int = 0
    spatial_verification: bool = False


class FeaturePipeline:
    """Extract + match + verify for a set of images.

    images: dict image_id -> (H, W) float32 grayscale array in [0, 1], all
    of one size; cameras: dict image_id -> Camera. `device` is where
    extraction, matching and verification run: the GPU unless "cpu" is
    asked for. `database_path`: the COLMAP database `run` writes, or
    loads when it already holds two-view geometries.
    """

    def __init__(self, images: dict, cameras: dict,
                 options: FeaturePipelineOptions | None = None,
                 device=None, database_path: str | None = None):
        self.images = images
        self.cameras = cameras
        self.opts = options or FeaturePipelineOptions()
        self.device = devmod.resolve(device)
        self.database_path = database_path
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
        with obs.span("extract") as s:
            self._extract_features()
        self.timings["extraction"] = s.seconds

    def _extract_features(self):
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

    def select_pairs(self) -> list:
        """Candidate pairs (i, j), i < j, by `pair_mode`. The device math
        (k-means, BoW, tree descent, signatures, Gabor, VLAD) runs on the
        pipeline's device."""
        ids = sorted(self.images)
        o, dev = self.opts, self.device
        if o.pair_mode == "exhaustive":
            return [(i, j) for (i, j, _) in rt.exhaustive_pairs(ids)]
        if o.pair_mode == "sequential":
            return [(i, j) for (i, j, _) in rt.sequential_pairs(
                ids, overlap=o.sequential_overlap,
                loop_detection_period=o.loop_detection_period,
                loop_detection_num_images=o.loop_detection_num_images,
                descriptors=self.descriptors, masks=self.masks,
                retrieval_opts=o.retrieval, seed=o.seed, device=dev)]
        if o.pair_mode == "retrieval":
            return [(i, j) for (i, j, _) in rt.similarity_pairs(
                self.descriptors, self.masks, o.retrieval, seed=o.seed,
                device=dev)]
        if o.pair_mode == "vocab_tree":
            return self._vocab_tree_pairs(ids)
        if o.pair_mode == "global":
            # VLAD over the SIFT descriptors when there are any, else the
            # Gabor embedding of the raw images
            if self.descriptors:
                descs = gd.vlad_descriptors(self.descriptors, self.masks,
                                            seed=o.seed, device=dev)
            else:
                descs = gd.global_descriptors(self.images, device=dev)
            return [(i, j) for (i, j, _) in gd.global_similarity_pairs(
                descs, num_neighbors=o.retrieval.num_neighbors)]
        raise ValueError(o.pair_mode)

    def _vocab_tree_pairs(self, ids: list) -> list:
        """A VisualIndex over a tree trained on (at most 20,000 of) the
        scene's own descriptors; each image's top num_neighbors, Hamming
        re-ranked when vocab_tree_rerank > 0, each new pair kept only if
        vote_and_verify scores >= 4 when spatial_verification is on."""
        train = np.concatenate(
            [self.descriptors[i][self.masks[i]] for i in ids])
        rng = np.random.default_rng(self.opts.seed)
        if len(train) > 20000:
            train = train[rng.choice(len(train), 20000, replace=False)]
        tree = vi.build_vocab_tree(train, vi.VocabTreeOptions(),
                                   seed=self.opts.seed, device=self.device)
        index = vi.VisualIndex(tree)
        for i in ids:
            index.add(i, self.descriptors[i][self.masks[i]],
                      keypoints=self.kp_geom[i][self.masks[i]]
                      if i in self.kp_geom else None)
        pairs = set()
        for i in ids:
            for j, _ in index.query(
                    i, num_images=self.opts.retrieval.num_neighbors,
                    rerank=self.opts.vocab_tree_rerank):
                pair = (i, j) if i < j else (j, i)
                if pair in pairs or pair[0] == pair[1]:
                    continue
                if self.opts.spatial_verification and i in self.kp_geom:
                    score, _ = vi.vote_and_verify(
                        self.kp_geom[pair[0]][self.masks[pair[0]]],
                        self.kp_geom[pair[1]][self.masks[pair[1]]],
                        index.match_words(pair[0], pair[1]))
                    if score < 4:
                        continue
                pairs.add(pair)
        return sorted(pairs)

    def match_and_verify(self, pairs: list | None = None):
        """Match `pairs` (None: `select_pairs()`) and verify each pair with
        full E/F/H classification, optionally guided re-matching. One
        root span, `verify.job`, counting its `pairs` and `classified`."""
        with obs.span("verify.job"):
            self._match_and_verify(pairs)

    def _match_and_verify(self, pairs):
        if pairs is None:
            with obs.span("select_pairs") as s:
                pairs = self.select_pairs()
            self.timings["pair_selection"] = s.seconds
        with obs.span("match") as s:
            raw = fm.match_pairs(self.descriptors, self.masks, pairs,
                                 self.opts.matching, bank=self.bank,
                                 device=self.device)
        self.timings["matching"] = s.seconds

        with obs.span("verify") as verify:
            with obs.span("verify.pack"):
                pair_data = []
                for (i, j), m in raw.items():
                    if len(m) < self.opts.min_num_inliers:
                        continue
                    cam_i, cam_j = self.cameras[i], self.cameras[j]
                    pair_data.append((
                        (i, j), self.keypoints[i][m[:, 0]],
                        self.keypoints[j][m[:, 1]],
                        cam_i.calibration_matrix(),
                        cam_j.calibration_matrix(),
                        (cam_i.width, cam_i.height),
                        (cam_j.width, cam_j.height),
                        cam_i.prior_focal and cam_j.prior_focal))
            tv_opts = tvc.TwoViewOptions(
                min_num_inliers=self.opts.min_num_inliers,
                max_error_px=self.opts.max_error_px,
                num_hypotheses=self.opts.num_ransac_hypotheses,
                essential_only=self.opts.two_view_essential_only)
            results = tvc.classify_pairs(pair_data, tv_opts,
                                         seed=self.opts.seed,
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
                    with obs.span("verify.guided") as g:
                        gm = self._guided_rematch((i, j), res)
                    t_guided += g.seconds
                    if gm is not None and len(gm) >= num_inliers:
                        inlier_matches, num_inliers = gm, len(gm)
                self.matches[(i, j)] = m
                self.two_view[(i, j)] = TwoViewRecord(
                    R=res.R, t=res.t, inlier_matches=inlier_matches,
                    num_inliers=num_inliers, config=res.config,
                    E=res.E, F=res.F, H=res.H)
        self.timings["verification"] = verify.seconds
        self.num_classified = len(pair_data)
        obs.count("pairs", len(pairs))
        obs.count("classified", len(pair_data))
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

    def write_database(self, path: str | None = None):
        """Cameras, images (named image{i:05d}.jpg), the masked keypoints
        and their uint8 descriptors, and every verified pair's matches and
        two-view geometry, indexed into the masked keypoints."""
        path = path or self.database_path
        if path is None:
            raise ValueError("write_database: no database path")
        with scene_io.ColmapDatabase(path) as db:
            for i in sorted(self.images):
                cam = self.cameras[i]
                db.add_camera(cam)
                db.add_image(f"image{i:05d}.jpg", cam.camera_id, image_id=i)
                db.add_keypoints(i, self.keypoints[i][self.masks[i]])
                db.add_descriptors(i, sift.descriptors_to_uint8(
                    self.descriptors[i][self.masks[i]]))
            for (i, j), m in self.matches.items():
                remap_i = np.cumsum(self.masks[i]) - 1
                remap_j = np.cumsum(self.masks[j]) - 1
                db.add_matches(i, j, np.stack([remap_i[m[:, 0]],
                                               remap_j[m[:, 1]]], 1))
                rec = self.two_view[(i, j)]
                inl = rec.inlier_matches
                db.add_two_view_geometry(
                    i, j, np.stack([remap_i[inl[:, 0]], remap_j[inl[:, 1]]],
                                   1),
                    config=rec.config, F=rec.F, E=rec.E, H=rec.H)

    @staticmethod
    def has_checkpoint(path: str | None) -> bool:
        """True if the database at `path` holds two-view geometries."""
        if path is None or not os.path.exists(path):
            return False
        with scene_io.ColmapDatabase(path) as db:
            return db.num_two_view_geometries() > 0

    def run(self):
        """Extract, match, verify and write the database; or, when the
        database already holds two-view geometries, load the mapper
        inputs from it and compute nothing (`timings` stays empty)."""
        if self.has_checkpoint(self.database_path):
            return self.load_from_database(self.database_path)
        self.extract_features()
        self.match_and_verify()
        if self.database_path:
            self.write_database()
        return self.to_mapper_inputs()

    def load_from_database(self, path: str):
        """(cameras, images, graph) from a database: keypoints as stored
        (float32) in float64, the verified matches in pair_id order."""
        with scene_io.ColmapDatabase(path) as db:
            cams = db.read_cameras()
            graph = CorrespondenceGraph()
            images = {}
            for i, (name, cam_id) in sorted(db.read_images().items()):
                kp = db.read_keypoints(i)[:, :2].astype(np.float64)
                graph.add_image(i, len(kp))
                images[i] = ImageRecord(
                    image_id=i, name=name, camera_id=cam_id,
                    qvec=np.array([1.0, 0, 0, 0]), tvec=np.zeros(3),
                    xys=kp, point3D_ids=np.full(len(kp), -1, np.int64))
            for (i, j, m, *_) in db.read_all_two_view_geometries():
                if len(m):
                    graph.add_matches(i, j, m)
        return cams, images, graph

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


def load_two_view_geometries_from_database(path: str, device=None) -> dict:
    """{(i, j): (R, t, num_inliers, config)} from a database: each stored
    winning model decomposed back into a relative pose on its stored
    inlier correspondences (COLMAP's LoadTwoviewGeometries), pairs with
    fewer than 5 inliers left out. CALIBRATED decomposes E, UNCALIBRATED
    Kj^T F Ki, the planar configs Kj^-1 H Ki; other configs give R = t =
    None. The E decompositions run batched on `device`."""
    dev = devmod.resolve(device)
    out = {}
    essential = []       # (pair, E, x1, x2) decomposed on the device
    with scene_io.ColmapDatabase(path) as db:
        cams = db.read_cameras()
        imgs = db.read_images()
        kps = {i: db.read_keypoints(i)[:, :2].astype(np.float64)
               for i in imgs}
        cam_of = {i: cams[cid] for i, (_, cid) in imgs.items()}
        for (i, j, m, config, F, E, H) in db.read_all_two_view_geometries():
            if len(m) < 5:
                continue
            Ki = cam_of[i].calibration_matrix()
            Kj = cam_of[j].calibration_matrix()
            x1 = (kps[i][m[:, 0]] - Ki[:2, 2]) / np.array([Ki[0, 0],
                                                           Ki[1, 1]])
            x2 = (kps[j][m[:, 1]] - Kj[:2, 2]) / np.array([Kj[0, 0],
                                                           Kj[1, 1]])
            out[(i, j)] = (None, None, len(m), config)
            if config == tvc.CALIBRATED and E is not None:
                essential.append(((i, j), np.asarray(E), x1, x2))
            elif config == tvc.UNCALIBRATED and F is not None:
                essential.append(((i, j), Kj.T @ np.asarray(F) @ Ki, x1, x2))
            elif config in (tvc.PLANAR, tvc.PANORAMIC,
                            tvc.PLANAR_OR_PANORAMIC) and H is not None:
                Hn = np.linalg.inv(Kj) @ np.asarray(H) @ Ki
                R, t, _ = tvc.pose_from_homography(Hn, x1, x2)
                out[(i, j)] = (R, t, len(m), config)
    for rows in tvc.length_batches([len(c[2]) for c in essential],
                                   tvc.BATCH_ELEMS):
        chunk = [essential[k] for k in rows]
        (x1, x2), mask = tvc.pad_pairs([c[2:] for c in chunk], dev)
        R, t, _ = epi.pose_from_essential(
            devmod.as_tensor(np.stack([c[1] for c in chunk]), dev),
            x1, x2, mask)
        R, t = R.cpu().numpy(), t.cpu().numpy()
        for k, (pk, *_) in enumerate(chunk):
            out[pk] = (R[k], t[k]) + out[pk][2:]
    return out


def load_features_from_database(path: str):
    """(cameras by image, keypoints, descriptors, masks, names, matched
    pairs, priors) from a database. Descriptors are dequantised (/ 512),
    L2-normalised and zero-padded to a common K, a multiple of 32, for
    batched matching."""
    with scene_io.ColmapDatabase(path) as db:
        cams = db.read_cameras()
        imgs = db.read_images()
        priors = db.read_image_priors()
        kps, descs = {}, {}
        for i in imgs:
            kps[i] = db.read_keypoints(i)[:, :2].astype(np.float64)
            d = db.read_descriptors(i).astype(np.float32) / 512.0
            n = np.linalg.norm(d, axis=1, keepdims=True)
            descs[i] = d / np.maximum(n, 1e-9)
        matched = [(i1, i2) for (i1, i2, m, *_)
                   in db.read_all_two_view_geometries() if len(m)]
    kmax = max([len(d) for d in descs.values()] + [32])
    kmax = int(np.ceil(kmax / 32) * 32)
    masks = {}
    for i, d in descs.items():
        pad = np.zeros((kmax, 128), np.float32)
        pad[:len(d)] = d
        descs[i] = pad
        masks[i] = np.arange(kmax) < len(d)
    cams_by_image = {i: cams[cid] for i, (_, cid) in imgs.items()}
    names = {i: name for i, (name, _) in imgs.items()}
    return cams_by_image, kps, descs, masks, names, matched, priors


def run_matcher_on_database(database_path: str, pairs: list,
                            options: FeaturePipelineOptions | None = None,
                            device=None) -> int:
    """Match and verify the given image-id pairs on a database of
    features (K1 on the card) and add each verified pair's matches and
    inliers to it (config CALIBRATED, no F/E/H, as the reference writes
    them). Pairs with fewer than min_num_inliers raw matches are skipped.
    Returns the number of pairs verified."""
    opts = options or FeaturePipelineOptions()
    dev = devmod.resolve(device)
    cams_by_image, kps, descs, masks, *_ = load_features_from_database(
        database_path)
    pairs = [(i, j) for (i, j) in pairs if i in descs and j in descs]
    if not pairs:
        return 0
    raw = fm.match_pairs(descs, masks, pairs, opts.matching, device=dev)
    pair_data = []
    for (i, j), m in raw.items():
        if len(m) < opts.min_num_inliers:
            continue
        Ki = cams_by_image[i].calibration_matrix()
        Kj = cams_by_image[j].calibration_matrix()
        x1 = (kps[i][m[:, 0]] - Ki[:2, 2]) / np.array([Ki[0, 0], Ki[1, 1]])
        x2 = (kps[j][m[:, 1]] - Kj[:2, 2]) / np.array([Kj[0, 0], Kj[1, 1]])
        pair_data.append(((i, j), x1, x2,
                          (opts.max_error_px / Ki[0, 0]) ** 2))
    results = verify_pairs(pair_data, num_hyps=opts.num_ransac_hypotheses,
                           seed=opts.seed, device=dev)
    n = 0
    with scene_io.ColmapDatabase(database_path) as db:
        for (i, j), (_, _, ninl, _, inl, valid) in results.items():
            if not valid or ninl < opts.min_num_inliers:
                continue
            m = raw[(i, j)]
            db.add_matches(i, j, m)
            db.add_two_view_geometry(i, j, m[inl], config=tvc.CALIBRATED)
            n += 1
    return n
