"""Incremental SfM mapper: host control loop over batched device steps.

Port of dagsfm_tpu/sfm/incremental_mapper.py (model snapshots wait).
Each geometric step is one batched call on the mapper's device —
essential RANSAC for the initial pair, P3P-RANSAC with its EPnP LO
refit plus Cauchy pose refinement for registration (over a grid of
focal lengths on the first registration of a camera without a focal
prior), two-view triangulation, bundle adjustment that refines the
intrinsics of cameras without a prior and every camera's distortion —
and the host keeps the graph-shaped bookkeeping.

Keypoints are normalised through the camera model (`cam_from_img`, the
iterative undistortion) one camera at a time: every keypoint of every
image of the camera in one call, kept until BA or the focal grid
rewrites the camera. Newton's steps act on each point alone, so this
gives the bits of the reference's per-call normalisation.

The reference pads every device call to power-of-two buckets to bound
its jit compiles; PyTorch runs eagerly, so the port passes exact sizes.
RANSAC samples come from a `torch.Generator` seeded with
`MapperOptions.seed` (the reference's jax.random stream cannot be
replayed).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.ops import absolute_pose as ap
from dagsfm_tpu_torch.ops import epipolar as epi
from dagsfm_tpu_torch.ops import ransac as rnsc
from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.ops import triangulation as tri
from dagsfm_tpu_torch.ops.projection import triangulation_angles
from dagsfm_tpu_torch.ops.two_view_classify import ransac_essential
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene.reconstruction import (Reconstruction,
                                                   scene_arrays_from_numpy)
from dagsfm_tpu_torch.sfm import bundle_adjustment as ba
from dagsfm_tpu_torch.sfm.correspondence_graph import CorrespondenceGraph


@dataclasses.dataclass
class MapperOptions:
    """Defaults as the reference (COLMAP incremental_mapper.h:66-134)."""
    init_min_num_inliers: int = 50
    init_min_tri_angle_deg: float = 4.0
    init_num_trials: int = 10
    abs_pose_max_error_px: float = 12.0
    abs_pose_min_num_inliers: int = 15
    abs_pose_min_inlier_ratio: float = 0.25
    filter_max_reproj_error_px: float = 4.0
    filter_min_tri_angle_deg: float = 1.5
    min_tri_angle_deg: float = 1.5
    tri_max_reproj_error_px: float = 8.0
    merge_max_reproj_error_px: float = 4.0
    complete_max_reproj_error_px: float = 4.0
    retri_min_ratio: float = 0.2
    retri_max_trials: int = 1
    complete_transitivity: int = 5
    ba_refine_focal: bool = True
    ba_refine_principal: bool = False
    ba_refine_extra: bool = True
    local_ba_num_images: int = 6
    ba_global_images_ratio: float = 1.1
    ba_global_points_ratio: float = 1.1
    ba_local_max_iterations: int = 15
    ba_global_max_iterations: int = 40
    num_ransac_hypotheses: int = 512
    max_track_len: int = 16
    registration_mode: str = "batch"   # 'batch' (top-5 per round) | 'strict'
    seed: int = 0


class IncrementalMapper:
    """Drives the reconstruction of one (sub-)scene.

    images: image_id -> ImageRecord with keypoints in `xys` (pixels);
    cameras: camera_id -> Camera; graph: verified matches. `device` is
    where the geometric steps run: the GPU unless "cpu" is asked for.
    """

    def __init__(self, cameras: dict, images: dict,
                 graph: CorrespondenceGraph,
                 options: MapperOptions | None = None, device=None):
        self.opts = options or MapperOptions()
        self.device = devmod.resolve(device)
        self.graph = graph
        self.rec = Reconstruction()
        for c in cameras.values():
            self.rec.add_camera(c)
        for im in images.values():
            self.rec.add_image(dataclasses.replace(
                im, point3D_ids=np.full(len(im.xys), -1, np.int64),
                registered=False))
        self._init_state()

    def _init_state(self) -> None:
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.opts.seed)
        self._num_reg_at_last_global_ba = self.rec.num_reg_images()
        self._num_pts_at_last_global_ba = self.rec.num_points3D()
        self._tried_init_pairs: set = set()
        self._failed_regs: dict = {}
        self._merge_candidates: set = set()
        self._retri_trials: dict = {}
        self._cam_snapshot: dict | None = None
        self._norm_cache: dict = {}   # camera_id -> (params, {image: uv})
        # the focal-grid factor picked at each camera's first registration
        self.focal_grid_factors: list = []

    @classmethod
    def wrap(cls, cameras: dict, rec: Reconstruction,
             graph: CorrespondenceGraph,
             options: MapperOptions | None = None,
             device=None) -> "IncrementalMapper":
        """A mapper over an existing reconstruction (the merged model), so
        that its triangulation, track and filtering steps can run on it;
        `rec` is changed in place and keeps its own cameras."""
        self = cls.__new__(cls)
        self.opts = options or MapperOptions()
        self.device = devmod.resolve(device)
        self.graph = graph
        self.rec = rec
        self._init_state()
        return self

    # ------------------------------------------------------------ utils
    def _t(self, a, dtype=devmod.DTYPE):
        return torch.as_tensor(np.array(a), dtype=dtype, device=self.device)

    def _cam_of(self, image_id: int) -> cm.Camera:
        return self.rec.cameras[self.rec.images[image_id].camera_id]

    def _normalize(self, image_id: int, xys: np.ndarray) -> np.ndarray:
        """Pixels -> normalized camera coordinates through the image's
        camera model (iterative undistortion)."""
        cam = self._cam_of(image_id)
        return cm.cam_from_img(cam.model_id, self._t(cam.padded_params()),
                               self._t(xys)).cpu().numpy()

    def _normalized(self, image_id: int, kp) -> np.ndarray:
        """Normalized coordinates of keypoints `kp` of an image. A miss
        normalises every keypoint of every image of the camera at once;
        the result stands until the camera's params change."""
        cam = self._cam_of(image_id)
        hit = self._norm_cache.get(cam.camera_id)
        if hit is None or hit[0] != cam.params:
            ids = [i for i, im in self.rec.images.items()
                   if im.camera_id == cam.camera_id]
            sizes = [len(self.rec.images[i].xys) for i in ids]
            uv = self._normalize(image_id, np.concatenate(
                [self.rec.images[i].xys for i in ids]).reshape(-1, 2))
            parts = np.split(uv, np.cumsum(sizes)[:-1])
            hit = (cam.params, dict(zip(ids, parts)))
            self._norm_cache[cam.camera_id] = hit
        return hit[1][image_id][kp]

    def _focal(self, image_id: int) -> float:
        return self._cam_of(image_id).focal()

    # ------------------------------------------------------ initial pair
    def find_initial_pair(self):
        """Pairs ranked by correspondence count; the first that verifies."""
        pairs = sorted(self.graph.image_pairs(),
                       key=lambda p: -len(self.graph.pair_matches[p]))
        for (i, j) in pairs:
            if (i, j) in self._tried_init_pairs:
                continue
            self._tried_init_pairs.add((i, j))
            if self._try_initialize(i, j):
                return (i, j)
        return None

    def _estimate_two_view(self, i: int, j: int, min_matches=None):
        m = self.graph.matches_between(i, j)
        if min_matches is None:
            min_matches = max(8, self.opts.init_min_num_inliers // 4)
        if len(m) < min_matches:
            return None
        x1 = self._t(self._normalized(i, m[:, 0]))[None]
        x2 = self._t(self._normalized(j, m[:, 1]))[None]
        mask = torch.ones((1, len(m)), dtype=torch.bool, device=self.device)
        thr = (self.opts.abs_pose_max_error_px / 3.0 / self._focal(i)) ** 2
        idx = rnsc.sample_indices(self._gen, mask,
                                  self.opts.num_ransac_hypotheses, 5)
        res = ransac_essential(x1, x2, mask, thr, idx)
        return m, x1[0], x2[0], res

    def _try_initialize(self, i: int, j: int) -> bool:
        out = self._estimate_two_view(
            i, j, min_matches=self.opts.init_min_num_inliers)
        if out is None:
            return False
        m, x1, x2, res = out
        if int(res.num_inliers[0]) < self.opts.init_min_num_inliers:
            return False
        R, t, n_front, X, ang, z1, z2 = (
            a.cpu().numpy() for a in _init_geometry(
                res.model[0], x1, x2, res.inliers[0]))
        if int(n_front) < self.opts.init_min_num_inliers:
            return False
        inl = res.inliers[0].cpu().numpy()
        good = inl & (z1 > 1e-3) & (z2 > 1e-3) & \
            (ang > self.opts.min_tri_angle_deg)
        if good.sum() < self.opts.init_min_num_inliers:
            return False
        if np.median(ang[good]) < self.opts.init_min_tri_angle_deg:
            return False
        imi, imj = self.rec.images[i], self.rec.images[j]
        imi.qvec, imi.tvec = np.array([1.0, 0, 0, 0]), np.zeros(3)
        imj.qvec, imj.tvec = rops.rotmat_to_quat_np(R), np.asarray(t)
        self.rec.register_image(i)
        self.rec.register_image(j)
        for k in np.nonzero(good)[0]:
            ki, kj = int(m[k, 0]), int(m[k, 1])
            if imi.point3D_ids[ki] >= 0 or imj.point3D_ids[kj] >= 0:
                continue
            self.rec.add_point3D(X[k], [(i, ki), (j, kj)])
        return True

    # ------------------------------------------------------ next images
    def find_next_images(self) -> list:
        """Unregistered images ranked by a visibility-pyramid score of their
        keypoints that see triangulated points."""
        reg = set(self.rec.reg_image_ids)
        scores = []
        for i, im in self.rec.images.items():
            if im.registered or i in reg:
                continue
            vis = []
            for j in self.graph.neighbors.get(i, ()):
                if j not in reg:
                    continue
                m = self.graph.matches_between(i, j)
                if len(m) == 0:
                    continue
                pid = self.rec.images[j].point3D_ids[m[:, 1]]
                sel = m[pid >= 0, 0]
                if len(sel):
                    vis.append(sel)
            if not vis:
                continue
            vis_kps = np.unique(np.concatenate(vis))
            cam = self._cam_of(i)
            pts = self.rec.images[i].xys[vis_kps.astype(np.int64)]
            score = float(len(vis_kps))
            for level in (2, 4, 8):
                gx = np.clip((pts[:, 0] / max(cam.width, 1) * level
                              ).astype(int), 0, level - 1)
                gy = np.clip((pts[:, 1] / max(cam.height, 1) * level
                              ).astype(int), 0, level - 1)
                score += len(np.unique(gy * level + gx)) * level
            score /= (1 + self._failed_regs.get(i, 0) * 2)
            scores.append((score, i))
        scores.sort(key=lambda s: -s[0])
        return [i for _, i in scores]

    # ------------------------------------------------- registration
    def _fail(self, image_id: int) -> bool:
        self._failed_regs[image_id] = self._failed_regs.get(image_id, 0) + 1
        return False

    def register_next_image(self, image_id: int) -> bool:
        """2D-3D P3P-RANSAC + pose refinement + observation insertion."""
        reg = set(self.rec.reg_image_ids)
        corrs = self.graph.correspondences_of_image(image_id, others=reg)
        kp2pts: dict[int, set] = {}
        for kp, j, kj in corrs:
            pid = self.rec.images[int(j)].point3D_ids[int(kj)]
            if pid >= 0:
                kp2pts.setdefault(int(kp), set()).add(int(pid))
        if len(kp2pts) < self.opts.abs_pose_min_num_inliers:
            return self._fail(image_id)
        kp_idx, pids = [], []
        for kp, pidset in kp2pts.items():
            for pid in pidset:
                kp_idx.append(kp)
                pids.append(pid)
        kp_idx = np.array(kp_idx)
        pids = np.array(pids)
        X = np.stack([self.rec.points3D[p].xyz for p in pids])
        cam = self._cam_of(image_id)
        # the focal grid runs on a camera's first registration only: once
        # an image of the camera is registered, BA owns its focal
        cam_in_use = any(self.rec.images[j].camera_id == cam.camera_id
                         for j in self.rec.reg_image_ids)
        if not cam.prior_focal and not cam_in_use:
            K = cam.calibration_matrix()
            centered = self.rec.images[image_id].xys[kp_idx] - K[:2, 2]
            idx = rnsc.sample_indices(
                self._gen, torch.ones((1, len(X)), dtype=torch.bool,
                                      device=self.device),
                self.opts.num_ransac_hypotheses, 3)
            _, _, num, factor = _ransac_p3p_focal(
                self._t(X), self._t(centered), cam.focal(),
                self.opts.abs_pose_max_error_px, idx)
            if int(num) >= self.opts.abs_pose_min_num_inliers:
                self.rec.cameras[cam.camera_id] = cm.scale_focal(
                    cam, float(factor))
                self.focal_grid_factors.append(float(factor))
        uv = self._normalized(image_id, kp_idx)
        thr = (self.opts.abs_pose_max_error_px / self._focal(image_id)) ** 2
        q2, t2, inliers, n_inl = (a.cpu().numpy() for a in _register_pose(
            self._gen, self._t(X), self._t(uv), thr,
            self.opts.num_ransac_hypotheses))
        n_inl = int(n_inl)
        if (n_inl < self.opts.abs_pose_min_num_inliers
                or n_inl < self.opts.abs_pose_min_inlier_ratio * len(kp2pts)):
            return self._fail(image_id)
        im = self.rec.images[image_id]
        im.qvec, im.tvec = q2, t2
        self.rec.register_image(image_id)
        used_kp = set()
        for k in np.nonzero(inliers)[0]:
            kp, pid = int(kp_idx[k]), int(pids[k])
            if kp in used_kp or im.point3D_ids[kp] >= 0:
                continue
            if pid not in self.rec.points3D:
                continue
            self.rec.add_observation(pid, image_id, kp)
            used_kp.add(kp)
        return True

    # ------------------------------------------------- triangulation
    def _triangulate(self, q1, t1, q2, t2, x1, x2, focal_image: int):
        """Batched two-view triangulation + the reference's checks.
        Returns (X (n, 3), good (n,))."""
        out = _triangulate_checked(*(self._t(a) for a in
                                     (q1, t1, q2, t2, x1, x2))).cpu().numpy()
        X, ang, e1, e2, z1, z2 = (out[:, :3], out[:, 3], out[:, 4],
                                  out[:, 5], out[:, 6], out[:, 7])
        thr = self.opts.tri_max_reproj_error_px / self._focal(focal_image)
        good = ((ang > np.radians(self.opts.min_tri_angle_deg))
                & (e1 < thr ** 2) & (e2 < thr ** 2)
                & (z1 > 1e-4) & (z2 > 1e-4))
        return X, good

    def triangulate_image(self, image_id: int) -> int:
        """Create points from matches of image_id to registered images
        (and continue existing tracks into their matches)."""
        im_i = self.rec.images[image_id]
        if not im_i.registered:
            return 0
        reg = set(self.rec.reg_image_ids) - {image_id}
        cand = []
        for kp, j, kj in self.graph.correspondences_of_image(
                image_id, others=reg):
            ki, j, kj = int(kp), int(j), int(kj)
            pid_i = im_i.point3D_ids[ki]
            pid_j = self.rec.images[j].point3D_ids[kj]
            if pid_i >= 0 and pid_j >= 0:
                if pid_i != pid_j:
                    self._merge_candidates.add(int(pid_i))
                continue
            if pid_i < 0 and pid_j >= 0:
                continue
            if pid_i >= 0 and pid_j < 0:
                pid = int(pid_i)
                if pid in self.rec.points3D and \
                        self._obs_ok(j, kj, self.rec.points3D[pid].xyz):
                    self.rec.add_observation(pid, j, kj)
                continue
            cand.append((j, ki, kj))
        if not cand:
            return 0
        cand = np.array(cand)
        n = len(cand)
        x1 = self._normalized(image_id, cand[:, 1])
        q2 = np.stack([self.rec.images[int(j)].qvec for j in cand[:, 0]])
        t2 = np.stack([self.rec.images[int(j)].tvec for j in cand[:, 0]])
        x2 = np.zeros((n, 2))
        for j in np.unique(cand[:, 0]):
            rows = np.nonzero(cand[:, 0] == j)[0]
            x2[rows] = self._normalized(int(j), cand[rows, 2])
        X, good = self._triangulate(
            np.broadcast_to(im_i.qvec, (n, 4)),
            np.broadcast_to(im_i.tvec, (n, 3)), q2, t2, x1, x2, image_id)
        created = 0
        for k in np.nonzero(good)[0]:
            j, ki, kj = (int(cand[k, 0]), int(cand[k, 1]), int(cand[k, 2]))
            if im_i.point3D_ids[ki] >= 0:
                pid = int(im_i.point3D_ids[ki])
                if self.rec.images[j].point3D_ids[kj] < 0 and \
                        pid in self.rec.points3D:
                    self.rec.add_observation(pid, j, kj)
                continue
            if self.rec.images[j].point3D_ids[kj] >= 0:
                continue
            self.rec.add_point3D(X[k], [(image_id, ki), (j, kj)])
            created += 1
        return created

    def _obs_ok(self, image_id: int, kp: int, xyz: np.ndarray,
                max_error_px: float | None = None) -> bool:
        im = self.rec.images[image_id]
        Xc = rops.quat_to_rotmat_np(im.qvec) @ xyz + im.tvec
        if Xc[2] < 1e-4:
            return False
        uv = self._normalized(image_id, kp)
        err = np.linalg.norm(Xc[:2] / Xc[2] - uv) * self._focal(image_id)
        if max_error_px is None:
            max_error_px = self.opts.tri_max_reproj_error_px
        return err < max_error_px

    # ---------------------------- triangulator merge/complete/retriangulate
    def merge_tracks(self, point_ids=None) -> int:
        """Fuse 3D points that are one physical track (COLMAP
        IncrementalTriangulator::Merge)."""
        if point_ids is None:
            point_ids = set(self._merge_candidates)
        self._merge_candidates.clear()
        merged = 0
        queue = list(point_ids)
        while queue:
            pid = queue.pop()
            if pid not in self.rec.points3D:
                continue
            new_pid = self._try_merge(pid)
            if new_pid is not None:
                merged += 1
                queue.append(new_pid)
        return merged

    def _merge_partners(self, pid: int) -> set:
        partners = set()
        for (i, kp) in self.rec.points3D[pid].track:
            for j, kj in self.graph.correspondences_of(int(i), int(kp)):
                im_j = self.rec.images.get(int(j))
                if im_j is None or not im_j.registered:
                    continue
                pid2 = int(im_j.point3D_ids[int(kj)])
                if pid2 >= 0 and pid2 != pid and pid2 in self.rec.points3D:
                    partners.add(pid2)
        return partners

    def _try_merge(self, pid: int):
        pt1 = self.rec.points3D[pid]
        for pid2 in sorted(self._merge_partners(pid)):
            pt2 = self.rec.points3D[pid2]
            n1, n2 = len(pt1.track), len(pt2.track)
            xyz = (n1 * pt1.xyz + n2 * pt2.xyz) / (n1 + n2)
            track = list(pt1.track) + list(pt2.track)
            imgs = [i for (i, _) in track]
            if len(set(imgs)) != len(imgs):
                continue
            if all(self._obs_ok(int(i), int(kp), xyz,
                                self.opts.merge_max_reproj_error_px)
                   for (i, kp) in track):
                self.rec.delete_point3D(pid)
                self.rec.delete_point3D(pid2)
                return self.rec.add_point3D(xyz, track)
        return None

    def complete_tracks(self, point_ids=None) -> int:
        """Extend tracks transitively along keypoint correspondences
        (COLMAP IncrementalTriangulator::Complete)."""
        if point_ids is None:
            point_ids = list(self.rec.points3D.keys())
        completed = 0
        for pid in point_ids:
            pt = self.rec.points3D.get(pid)
            if pt is None:
                continue
            queue = list(pt.track)
            depth = 0
            while queue and depth < self.opts.complete_transitivity:
                depth += 1
                nxt = []
                for (i, kp) in queue:
                    for j, kj in self.graph.correspondences_of(int(i), int(kp)):
                        j, kj = int(j), int(kj)
                        im_j = self.rec.images.get(j)
                        if im_j is None or not im_j.registered:
                            continue
                        if im_j.point3D_ids[kj] >= 0:
                            continue
                        if not self._obs_ok(
                                j, kj, pt.xyz,
                                self.opts.complete_max_reproj_error_px):
                            continue
                        self.rec.add_observation(pid, j, kj)
                        nxt.append((j, kj))
                        completed += 1
                queue = nxt
        return completed

    def retriangulate(self) -> int:
        """Another create pass over under-reconstructed registered pairs
        (COLMAP IncrementalTriangulator::Retriangulate)."""
        created = 0
        reg = set(self.rec.reg_image_ids)
        for (i, j) in self.graph.image_pairs():
            if i not in reg or j not in reg:
                continue
            m = self.graph.matches_between(i, j)
            if len(m) == 0:
                continue
            pi = self.rec.images[i].point3D_ids[m[:, 0]]
            pj = self.rec.images[j].point3D_ids[m[:, 1]]
            if float(((pi >= 0) & (pi == pj)).sum()) / len(m) >= \
                    self.opts.retri_min_ratio:
                continue
            trials = self._retri_trials.get((i, j), 0)
            if trials >= self.opts.retri_max_trials:
                continue
            self._retri_trials[(i, j)] = trials + 1
            created += self._triangulate_pair(i, j, m)
        return created

    def _triangulate_pair(self, i: int, j: int, m: np.ndarray) -> int:
        im_i, im_j = self.rec.images[i], self.rec.images[j]
        free = (im_i.point3D_ids[m[:, 0]] < 0) & \
            (im_j.point3D_ids[m[:, 1]] < 0)
        cand = m[free]
        if len(cand) == 0:
            return 0
        n = len(cand)
        X, good = self._triangulate(
            np.broadcast_to(im_i.qvec, (n, 4)),
            np.broadcast_to(im_i.tvec, (n, 3)),
            np.broadcast_to(im_j.qvec, (n, 4)),
            np.broadcast_to(im_j.tvec, (n, 3)),
            self._normalized(i, cand[:, 0]),
            self._normalized(j, cand[:, 1]), i)
        created = 0
        for k in np.nonzero(good)[0]:
            ki, kj = int(cand[k, 0]), int(cand[k, 1])
            if im_i.point3D_ids[ki] >= 0 or im_j.point3D_ids[kj] >= 0:
                continue
            self.rec.add_point3D(X[k], [(i, ki), (j, kj)])
            created += 1
        return created

    # ------------------------------------------------- bundle adjustment
    def _run_ba(self, image_ids: list, max_iterations: int,
                const_images: set):
        """BA over the given registered images and their points, with one
        pose pinned for the gauge when no image is held constant."""
        id_list = sorted(set(image_ids))
        pids = set()
        for i in id_list:
            for pid in self.rec.images[i].point3D_ids:
                if pid >= 0:
                    pids.add(int(pid))
        arrays, ids = _export_sub_arrays(self.rec, id_list, sorted(pids),
                                         self.device)
        if arrays is None:
            return
        cam_ids, img_ids, pt_ids = ids
        const = np.array([i in const_images for i in img_ids], bool)
        if const.sum() == 0 and len(img_ids) >= 2:
            const[:1] = True
        cam_refine = cm.intrinsics_refine_mask(
            arrays.cam_model_id.cpu().numpy(), self.opts.ba_refine_focal,
            self.opts.ba_refine_principal, self.opts.ba_refine_extra,
            eligible=[not self.rec.cameras[c].prior_focal for c in cam_ids],
            eligible_extra=np.ones(len(cam_ids), bool))
        refine_on = bool(cam_refine.any())
        prob = ba.make_problem(arrays, max_track_len=self.opts.max_track_len,
                               const_image=const,
                               cam_refine=cam_refine if refine_on else None)
        opts = ba.BAOptions(
            loss="cauchy", loss_scale=1.0,
            refine_focal=refine_on and self.opts.ba_refine_focal,
            refine_principal=refine_on and self.opts.ba_refine_principal,
            refine_extra=refine_on and self.opts.ba_refine_extra)
        prob, _stats = ba.solve(prob, opts, max_iters=max_iterations)
        if refine_on:
            newp = prob.cam_params.cpu().numpy()
            for k, c in enumerate(cam_ids):
                cam = self.rec.cameras[c]
                self.rec.cameras[c] = cam._replace(params=tuple(
                    float(v) for v in newp[k, :len(cam.params)]))
        q = prob.image_qvec.cpu().numpy()
        t = prob.image_tvec.cpu().numpy()
        X = prob.points.cpu().numpy()
        for k, i in enumerate(img_ids):
            self.rec.images[i].qvec = q[k]
            self.rec.images[i].tvec = t[k]
        for k, p in enumerate(pt_ids):
            if p in self.rec.points3D:
                self.rec.points3D[p].xyz = X[k]

    def _local_refine(self, image_ids: list) -> None:
        """Complete/merge around the new images, local BA, then the
        global-BA growth check."""
        local_pts = [int(p) for i in image_ids
                     for p in self.rec.images[i].point3D_ids if p >= 0]
        self.complete_tracks(local_pts)
        self.merge_tracks()
        self.adjust_local_bundle(image_ids)
        if self.needs_global_ba():
            self.retriangulate()
            self.complete_tracks()
            self.merge_tracks(set(self.rec.points3D.keys()))
            self.adjust_global_bundle()
            self.filter_points()

    def adjust_local_bundle(self, image_ids):
        """BA over the most-connected registered neighbours of the image(s)."""
        if isinstance(image_ids, (int, np.integer)):
            image_ids = [int(image_ids)]
        new = list(dict.fromkeys(int(i) for i in image_ids))
        shared: dict[int, int] = {}
        for image_id in new:
            for pid in self.rec.images[image_id].point3D_ids:
                if pid < 0 or int(pid) not in self.rec.points3D:
                    continue
                for (j, _) in self.rec.points3D[int(pid)].track:
                    if j not in new:
                        shared[j] = shared.get(j, 0) + 1
        budget = max(self.opts.local_ba_num_images - len(new), len(new))
        local = sorted(shared, key=lambda j: -shared[j])[:budget] + new
        const = set(local[:2]) - set(new)
        if not const:
            const = set(local[:1])
        self._run_ba(local, self.opts.ba_local_max_iterations, const)

    def adjust_global_bundle(self):
        reg = self.rec.reg_image_ids
        if len(reg) < 2:
            return
        self._run_ba(reg, self.opts.ba_global_max_iterations, set(reg[:1]))
        self.rec.filter_images()
        self._num_reg_at_last_global_ba = len(reg)
        self._num_pts_at_last_global_ba = self.rec.num_points3D()

    def needs_global_ba(self) -> bool:
        growth_i = self.rec.num_reg_images() / max(
            self._num_reg_at_last_global_ba, 1)
        growth_p = self.rec.num_points3D() / max(
            self._num_pts_at_last_global_ba, 1)
        return (growth_i > self.opts.ba_global_images_ratio
                or growth_p > self.opts.ba_global_points_ratio)

    # ------------------------------------------------- filtering
    def filter_points(self) -> int:
        """Drop observations with large reprojection error or behind the
        camera, then points whose track spans too small an angle."""
        pids = list(self.rec.points3D.keys())
        if not pids:
            return 0
        img_ids = self.rec.reg_image_ids
        img_index = {i: k for k, i in enumerate(img_ids)}
        R_all = rops.quat_to_rotmat_np(
            np.stack([self.rec.images[i].qvec for i in img_ids]))
        t_all = np.stack([self.rec.images[i].tvec for i in img_ids])
        C_all = -np.einsum("nij,ni->nj", R_all, t_all)
        foc = np.array([self._focal(i) for i in img_ids])
        obs_pid, obs_img, obs_kp = [], [], []
        pt_index = {}
        X_list = []
        for pid in pids:
            pt = self.rec.points3D[pid]
            pt_index[pid] = len(X_list)
            X_list.append(pt.xyz)
            for (i, kp) in pt.track:
                obs_pid.append(pid)
                obs_img.append(img_index[i])
                obs_kp.append(kp)
        X = np.stack(X_list)
        oi = np.array(obs_img)
        okp = np.array(obs_kp)
        op = np.array([pt_index[p] for p in obs_pid])
        Xc = np.einsum("nij,nj->ni", R_all[oi], X[op]) + t_all[oi]
        uv_obs = np.zeros((len(oi), 2))
        for k in np.unique(oi):
            rows = np.nonzero(oi == k)[0]
            img_id = img_ids[k]
            uv_obs[rows] = self._normalized(img_id, okp[rows])
        z = Xc[:, 2]
        behind = z < 1e-4
        zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
        err = np.linalg.norm(Xc[:, :2] / zs[:, None] - uv_obs, axis=1) \
            * foc[oi]
        bad = behind | (err > self.opts.filter_max_reproj_error_px)
        removed = 0
        for n in np.nonzero(bad)[0]:
            pid = obs_pid[n]
            if pid in self.rec.points3D:
                i, kp = img_ids[obs_img[n]], obs_kp[n]
                if (i, kp) in self.rec.points3D[pid].track:
                    self.rec.delete_observation(pid, i, kp)
        removed += sum(1 for p in pids if p not in self.rec.points3D)

        alive = [p for p in pids if p in self.rec.points3D]
        if alive:
            T = max(len(self.rec.points3D[p].track) for p in alive)
            P = len(alive)
            dirs = np.zeros((P, T, 3))
            dmask = np.zeros((P, T), bool)
            for a, pid in enumerate(alive):
                pt = self.rec.points3D[pid]
                for b, (i, _) in enumerate(pt.track):
                    dirs[a, b] = C_all[img_index[i]] - pt.xyz
                    dmask[a, b] = True
            norm = np.linalg.norm(dirs, axis=-1)
            dn = dirs / np.where(norm < 1e-12, 1.0, norm)[..., None]
            min_cos = np.ones(P)
            chunk = max(1, (1 << 22) // max(T * T, 1))
            for s in range(0, P, chunk):
                e = min(s + chunk, P)
                cos = np.einsum("ptk,psk->pts", dn[s:e], dn[s:e])
                pairm = dmask[s:e, :, None] & dmask[s:e, None, :]
                min_cos[s:e] = np.where(pairm, cos, 1.0).min(axis=(1, 2))
            max_ang = np.degrees(np.arccos(np.clip(min_cos, -1, 1)))
            for a in np.nonzero(
                    max_ang < self.opts.filter_min_tri_angle_deg)[0]:
                self.rec.delete_point3D(alive[a])
                removed += 1

        ok = ~bad
        for n in np.nonzero(ok)[0]:
            pt = self.rec.points3D.get(obs_pid[n])
            if pt is not None and pt.error < 0:
                pt.error = 0.0
        sums: dict = {}
        cnts: dict = {}
        for n in np.nonzero(ok)[0]:
            pid = obs_pid[n]
            if pid in self.rec.points3D:
                sums[pid] = sums.get(pid, 0.0) + err[n]
                cnts[pid] = cnts.get(pid, 0) + 1
        for pid, s in sums.items():
            self.rec.points3D[pid].error = s / cnts[pid]
        return removed

    # ------------------------------------------------- main loop
    def _reset_model(self) -> None:
        """Tear the model down for an init-pair retry: failure counters
        cleared and the cameras put back as they were before the first
        trial (a failed trial's BA refined the shared intrinsics)."""
        for pid in list(self.rec.points3D):
            self.rec.delete_point3D(pid)
        for i in list(self.rec.reg_image_ids):
            self.rec.deregister_image(i)
        if self._cam_snapshot is not None:
            self.rec.cameras.clear()
            self.rec.cameras.update(self._cam_snapshot)
        self._failed_regs = {}
        self._num_reg_at_last_global_ba = 0
        self._num_pts_at_last_global_ba = 0

    def reconstruct(self) -> Reconstruction:
        """Full incremental pipeline with init-pair retries: a bootstrap
        that never grows past its two images is torn down and the next
        initial pair is tried."""
        last_pair = None
        self._cam_snapshot = dict(self.rec.cameras)
        pair = self.find_initial_pair()
        for trial in range(self.opts.init_num_trials):
            if pair is None:
                break
            last_pair = pair
            self._bootstrap_and_grow(pair)
            if self.rec.num_reg_images() > 2:
                break
            if trial + 1 >= self.opts.init_num_trials:
                break
            self._reset_model()
            pair = self.find_initial_pair()
        if self.rec.num_reg_images() < 2 and last_pair is not None:
            self._tried_init_pairs.discard(last_pair)
            if self.find_initial_pair() is not None:
                self._bootstrap_and_grow(last_pair)
        if self.rec.num_reg_images() < 2:
            return self.rec
        self.retriangulate()
        self.complete_tracks()
        self.merge_tracks(set(self.rec.points3D.keys()))
        self.adjust_global_bundle()
        self.filter_points()
        self.adjust_global_bundle()
        return self.rec

    def _count_2d3d(self, image_id: int) -> int:
        reg = set(self.rec.reg_image_ids)
        kps = set()
        for kp, j, kj in self.graph.correspondences_of_image(
                image_id, others=reg):
            if self.rec.images[int(j)].point3D_ids[int(kj)] >= 0:
                kps.add(int(kp))
        return len(kps)

    def _bootstrap_viable(self) -> bool:
        need = self.opts.abs_pose_min_num_inliers
        return any(self._count_2d3d(i) >= need
                   for i in self.find_next_images()[:10])

    def _bootstrap_and_grow(self, pair) -> None:
        i0, j0 = pair
        self.triangulate_image(i0)
        self.triangulate_image(j0)
        self.adjust_global_bundle()
        self.filter_points()
        if self.rec.num_points3D() and not self._bootstrap_viable():
            return
        strict = self.opts.registration_mode == "strict"
        per_round = 1 if strict else 5
        stall = 0
        while stall < 2:
            nxt = self.find_next_images()
            if not nxt:
                break
            progressed = False
            new_imgs = []
            for image_id in nxt[:per_round]:
                if not self.register_next_image(image_id):
                    continue
                self.triangulate_image(image_id)
                new_imgs.append(image_id)
                progressed = True
                if strict:
                    self._local_refine([image_id])
            if not strict and new_imgs:
                self._local_refine(new_imgs)
            stall = 0 if progressed else stall + 1


# ---------------------------------------------------------------------------
# batched device steps
# ---------------------------------------------------------------------------

def _p3p_solver(Xs, uvs):
    Rs, ts, ok = ap.p3p(Xs, uvs)
    return torch.cat([Rs, ts[..., None]], dim=-1), ok


def _pose_residual(M, Xd, uvd):
    return ap.pose_reproj_error(M[..., :3], M[..., 3], Xd[:, None],
                                uvd[:, None])


def _epnp_refit(Xd, uvd, inl):
    R, t, _ = ap.epnp(Xd, uvd, mask=inl)
    return torch.cat([R, t[..., None]], dim=-1)


def ransac_p3p(X, uv, thr, sample_idx):
    """P3P LO-RANSAC with the EPnP refit on the inliers over a batch:
    X (B, N, 3), uv (B, N, 2), thr scalar or (B,), sample_idx (B, H, 3)."""
    mask = torch.ones(uv.shape[:2], dtype=torch.bool, device=X.device)
    return rnsc.ransac(_p3p_solver, _pose_residual, (X, uv), mask,
                       sample_idx, thr, refit=_epnp_refit)


def _ransac_p3p_focal(X, centered, focal0: float, thr_px: float,
                      sample_idx, num_samples: int = 15):
    """P3P-RANSAC over a grid of focal lengths (the reference's
    estimate_focal_length): 15 log-spaced factors of focal0 from 0.2 to
    5, one batch row each, all on the same (1, H, 3) sample set; the
    first factor with the most inliers wins. X (N, 3), centered (N, 2)
    pixels minus the principal point. Returns (model (3, 4), inliers (N,),
    num_inliers, factor)."""
    factors = torch.as_tensor(np.exp(np.linspace(np.log(0.2), np.log(5.0),
                                                 num_samples)),
                              dtype=X.dtype, device=X.device)
    f = focal0 * factors
    uv = centered[None] / f[:, None, None]
    res = ransac_p3p(X[None].expand(num_samples, -1, -1), uv,
                     (thr_px / f) ** 2,
                     sample_idx.expand(num_samples, -1, -1))
    best = torch.argmax(res.num_inliers)
    return (res.model[best], res.inliers[best], res.num_inliers[best],
            factors[best])


def _register_pose(gen, X, uv, thr, num_hyps):
    """P3P LO-RANSAC (EPnP refit) + Cauchy pose refinement on the
    inliers. Returns (qvec, tvec, inliers, num_inliers)."""
    mask = torch.ones((1, X.shape[0]), dtype=torch.bool, device=X.device)
    res = ransac_p3p(X[None], uv[None], thr,
                     rnsc.sample_indices(gen, mask, num_hyps, 3))
    Rt = res.model[0]
    R2, t2 = ap.refine_pose(Rt[:, :3], Rt[:, 3], X, uv, res.inliers[0])
    return rops.rotmat_to_quat(R2), t2, res.inliers[0], res.num_inliers[0]


def _init_geometry(model, x1, x2, inliers):
    """Pose from the essential matrix, two-view triangulation, angles (deg)
    and depths in both views."""
    R, t, n_front = epi.pose_from_essential(model, x1, x2, inliers)
    N, dt, dev = x1.shape[0], x1.dtype, x1.device
    q1 = torch.zeros((N, 4), dtype=dt, device=dev)
    q1[:, 0] = 1.0
    t1 = torch.zeros((N, 3), dtype=dt, device=dev)
    q2 = rops.rotmat_to_quat(R).expand(N, 4)
    t2 = t.expand(N, 3)
    X = tri.triangulate_two_view(q1, t1, q2, t2, x1, x2)
    ang = triangulation_angles(q1, t1, q2, t2, X)
    return R, t, n_front, X, torch.rad2deg(ang), X[:, 2], (X @ R.T + t)[:, 2]


def _triangulate_checked(q1, t1, q2, t2, x1, x2):
    """(N, 8): xyz, angle (rad), squared normalized reprojection errors in
    both views, depths in both views."""
    X = tri.triangulate_two_view(q1, t1, q2, t2, x1, x2)
    ang = triangulation_angles(q1, t1, q2, t2, X)
    Xc1 = rops.quat_rotate(q1, X) + t1
    Xc2 = rops.quat_rotate(q2, X) + t2
    z1, z2 = Xc1[:, 2], Xc2[:, 2]

    def nz(z):
        return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)

    e1 = torch.sum((Xc1[:, :2] / nz(z1)[:, None] - x1) ** 2, -1)
    e2 = torch.sum((Xc2[:, :2] / nz(z2)[:, None] - x2) ** 2, -1)
    return torch.cat([X, ang[:, None], e1[:, None], e2[:, None],
                      z1[:, None], z2[:, None]], dim=-1)


def _export_sub_arrays(rec: Reconstruction, image_ids: list,
                       point_ids: list, device):
    """SceneArrays (exact sizes) for a subset of images and their points
    with >= 2 observations among those images."""
    img_set = set(image_ids)
    cam_ids = sorted({rec.images[i].camera_id for i in image_ids})
    cam_index = {c: k for k, c in enumerate(cam_ids)}
    img_index = {i: k for k, i in enumerate(image_ids)}
    cam_params = np.zeros((len(cam_ids), cm.MAX_CAMERA_PARAMS))
    for k, c in enumerate(cam_ids):
        p = np.asarray(rec.cameras[c].params)
        cam_params[k, : len(p)] = p
    pts, pt_keep, obs = [], [], []
    for p in point_ids:
        pt = rec.points3D.get(p)
        if pt is None:
            continue
        track = [(i, kp) for (i, kp) in pt.track if i in img_set]
        if len(track) < 2:
            continue
        pidx = len(pts)
        pts.append(pt.xyz)
        pt_keep.append(p)
        for (i, kp) in track:
            obs.append((img_index[i], pidx, rec.images[i].xys[kp]))
    if not pts or not obs:
        return None, None
    arrays = scene_arrays_from_numpy(dict(
        cam_model_id=[rec.cameras[c].model_id for c in cam_ids],
        cam_params=cam_params,
        image_qvec=np.stack([rec.images[i].qvec for i in image_ids]),
        image_tvec=np.stack([rec.images[i].tvec for i in image_ids]),
        image_camidx=[cam_index[rec.images[i].camera_id] for i in image_ids],
        image_mask=np.ones(len(image_ids), bool),
        points_xyz=np.stack(pts), points_mask=np.ones(len(pts), bool),
        obs_image=[o[0] for o in obs], obs_point=[o[1] for o in obs],
        obs_xy=np.stack([o[2] for o in obs]),
        obs_mask=np.ones(len(obs), bool)), device)
    return arrays, (cam_ids, image_ids, pt_keep)
