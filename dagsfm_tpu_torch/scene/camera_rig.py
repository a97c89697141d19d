"""Camera rigs: cameras with fixed relative poses, and their snapshots.

Port of dagsfm_tpu/scene/camera_rig.py (COLMAP base/camera_rig): a rig
holds each camera's cam-from-rig mount and its snapshots, the groups of
images (one per rig camera) taken at one instant. Host code in numpy;
`make_rig_ba_problem` places the rig BA problem on `device`.

Poses follow COLMAP: x_cam = R_cam_from_rig x_rig + t_cam_from_rig and
x_rig = R_rig_from_world x_world + t_rig_from_world.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.sfm.rig_bundle_adjustment import RigBAProblem


def _compose(q_ab, t_ab, q_bc, t_bc):
    """T_ac = T_ab ∘ T_bc: x_a = R_ab (R_bc x_c + t_bc) + t_ab."""
    R_ab = rops.quat_to_rotmat_np(q_ab)
    R_ac = R_ab @ rops.quat_to_rotmat_np(q_bc)
    t_ac = R_ab @ np.asarray(t_bc, float) + np.asarray(t_ab, float)
    return rops.rotmat_to_quat_np(R_ac), t_ac


def _invert(q, t):
    R = rops.quat_to_rotmat_np(q)
    return rops.rotmat_to_quat_np(R.T), -R.T @ np.asarray(t, float)


def _average_quat(qs: list) -> np.ndarray:
    """The principal eigenvector of Σ q qᵀ over sign-aligned quaternions,
    unit, w >= 0."""
    Q = np.stack([q if q[0] >= 0 else -q for q in qs])
    _, V = np.linalg.eigh(Q.T @ Q)
    q = V[:, -1]
    return -q if q[0] < 0 else q


@dataclasses.dataclass
class CameraRig:
    """COLMAP's CameraRig: AddCamera, AddSnapshot, SetRefCameraId,
    Check, ComputeRigFromWorld, ComputeRelativePoses."""

    cam_from_rig_q: dict = dataclasses.field(default_factory=dict)
    cam_from_rig_t: dict = dataclasses.field(default_factory=dict)
    snapshots: list = dataclasses.field(default_factory=list)
    ref_camera_id: int | None = None

    def add_camera(self, camera_id: int, qvec, tvec) -> None:
        self.cam_from_rig_q[camera_id] = np.asarray(qvec, float)
        self.cam_from_rig_t[camera_id] = np.asarray(tvec, float)

    def add_snapshot(self, image_ids: list) -> None:
        self.snapshots.append(list(image_ids))

    def set_ref_camera_id(self, camera_id: int) -> None:
        assert camera_id in self.cam_from_rig_q
        self.ref_camera_id = camera_id

    @property
    def num_cameras(self) -> int:
        return len(self.cam_from_rig_q)

    @property
    def num_snapshots(self) -> int:
        return len(self.snapshots)

    def check(self, rec) -> None:
        """Every snapshot's images use rig cameras, each at most once."""
        for snap in self.snapshots:
            seen = set()
            for iid in snap:
                cid = rec.images[iid].camera_id
                assert cid in self.cam_from_rig_q, \
                    f"camera {cid} not in rig"
                assert cid not in seen, f"camera {cid} twice in snapshot"
                seen.add(cid)

    def normalize_to_ref(self) -> None:
        """Re-express the mounts so that the reference camera's is the
        identity (the rig frame becomes the reference camera's)."""
        assert self.ref_camera_id is not None
        q0i, t0i = _invert(self.cam_from_rig_q[self.ref_camera_id].copy(),
                           self.cam_from_rig_t[self.ref_camera_id].copy())
        for cid in self.cam_from_rig_q:
            self.cam_from_rig_q[cid], self.cam_from_rig_t[cid] = _compose(
                self.cam_from_rig_q[cid], self.cam_from_rig_t[cid],
                q0i, t0i)

    def compute_rig_from_world(self, snapshot_idx: int, rec):
        """A snapshot's rig-from-world pose (qvec, tvec): the quaternion
        average and the mean translation of its images' estimates."""
        qs, ts = [], []
        for iid in self.snapshots[snapshot_idx]:
            im = rec.images[iid]
            q_rc, t_rc = _invert(self.cam_from_rig_q[im.camera_id],
                                 self.cam_from_rig_t[im.camera_id])
            q_rw, t_rw = _compose(q_rc, t_rc, im.qvec, im.tvec)
            qs.append(q_rw)
            ts.append(t_rw)
        q = _average_quat(qs)
        return q / np.linalg.norm(q), np.mean(np.stack(ts), axis=0)

    def image_pose(self, camera_id: int, q_rig_world, t_rig_world):
        """cam-from-world = cam-from-rig ∘ rig-from-world."""
        return _compose(self.cam_from_rig_q[camera_id],
                        self.cam_from_rig_t[camera_id],
                        q_rig_world, t_rig_world)

    def compute_relative_poses(self, rec) -> None:
        """Each mount from the registered image poses: the average of
        cam_from_world ∘ world_from_ref over the snapshots that hold the
        reference camera (the rig frame is the reference camera's)."""
        assert self.ref_camera_id is not None
        acc_q = {cid: [] for cid in self.cam_from_rig_q}
        acc_t = {cid: [] for cid in self.cam_from_rig_q}
        for snap in self.snapshots:
            ref_im = None
            for iid in snap:
                if rec.images[iid].camera_id == self.ref_camera_id:
                    ref_im = rec.images[iid]
            if ref_im is None:
                continue
            q_wr, t_wr = _invert(ref_im.qvec, ref_im.tvec)
            for iid in snap:
                im = rec.images[iid]
                q, t = _compose(im.qvec, im.tvec, q_wr, t_wr)
                acc_q[im.camera_id].append(q)
                acc_t[im.camera_id].append(t)
        for cid in self.cam_from_rig_q:
            if not acc_q[cid]:
                continue
            q = _average_quat(acc_q[cid])
            self.cam_from_rig_q[cid] = q / np.linalg.norm(q)
            self.cam_from_rig_t[cid] = np.mean(np.stack(acc_t[cid]), axis=0)


def read_rig_config(path: str, rec) -> list:
    """Camera rigs from COLMAP's JSON rig config: a list of {"cameras":
    [{"camera_id", "image_prefix"}, ...], "ref_camera_id"}. The registered
    images are grouped into snapshots by the name's suffix after a
    camera's prefix; a snapshot is kept when it holds the reference
    camera. The mounts come from the registered poses."""
    with open(path) as f:
        cfg = json.load(f)
    rigs = []
    for rig_cfg in cfg:
        rig = CameraRig()
        prefixes = []
        for cam in rig_cfg["cameras"]:
            prefixes.append(cam["image_prefix"])
            rig.add_camera(cam["camera_id"], np.array([1.0, 0, 0, 0]),
                           np.zeros(3))
        rig.set_ref_camera_id(rig_cfg["ref_camera_id"])
        snapshots: dict = {}
        for iid in rec.reg_image_ids:
            name = rec.images[iid].name
            for prefix in prefixes:
                if prefix in name:
                    snapshots.setdefault(name.split(prefix, 1)[1],
                                         []).append(iid)
        for suffix in sorted(snapshots):
            snap = snapshots[suffix]
            if any(rec.images[iid].camera_id == rig.ref_camera_id
                   for iid in snap):
                rig.add_snapshot(snap)
        rig.check(rec)
        rig.compute_relative_poses(rec)
        rigs.append(rig)
    return rigs


def make_rig_ba_problem(rec, rigs: list, cameras: dict | None = None,
                        device=None):
    """(RigBAProblem on `device`, meta) from a reconstruction and its rigs
    (what COLMAP's rig_bundle_adjuster sets up). A registered image that
    no snapshot covers becomes a snapshot of its own with an identity
    mount per camera. meta holds what `apply_rig_ba_result` writes back
    through: the snapshots, the mount of each (rig, camera), point ids."""
    dev = devmod.resolve(device)
    cameras = cameras or rec.cameras
    mount_key, mount_q, mount_t = {}, [], []
    snaps = []          # (image_ids, rig index or None, q, t)
    covered = set()
    for ridx, rig in enumerate(rigs):
        for cid in sorted(rig.cam_from_rig_q):
            mount_key[(ridx, cid)] = len(mount_q)
            mount_q.append(rig.cam_from_rig_q[cid])
            mount_t.append(rig.cam_from_rig_t[cid])
        for sidx, snap in enumerate(rig.snapshots):
            q, t = rig.compute_rig_from_world(sidx, rec)
            snaps.append((list(snap), ridx, q, t))
            covered.update(snap)
    for iid in rec.reg_image_ids:
        if iid in covered:
            continue
        im = rec.images[iid]
        if ("free", im.camera_id) not in mount_key:
            mount_key[("free", im.camera_id)] = len(mount_q)
            mount_q.append(np.array([1.0, 0, 0, 0]))
            mount_t.append(np.zeros(3))
        snaps.append(([iid], None, np.asarray(im.qvec, float),
                      np.asarray(im.tvec, float)))

    pt_ids = sorted(rec.points3D)
    snap_of = {iid: (sidx, ridx)
               for sidx, (ims, ridx, _, _) in enumerate(snaps)
               for iid in ims}
    snap_idx, cam_idx, pt_idx, obs_xy, focal, pp = [], [], [], [], {}, {}
    for k, pid in enumerate(pt_ids):
        for iid, kp in rec.points3D[pid].track:
            if iid not in snap_of:
                continue
            sidx, ridx = snap_of[iid]
            cid = rec.images[iid].camera_id
            midx = mount_key[(ridx, cid) if ridx is not None
                             else ("free", cid)]
            cam = cameras[cid]
            f = cam.focal()
            focal[midx] = float(np.mean(f)) if np.ndim(f) else float(f)
            K = np.asarray(cam.calibration_matrix())
            pp[midx] = (float(K[0, 2]), float(K[1, 2]))
            snap_idx.append(sidx)
            cam_idx.append(midx)
            pt_idx.append(k)
            obs_xy.append(rec.images[iid].xys[kp])
    C = len(mount_q)
    T = (lambda a: devmod.as_tensor(np.asarray(a, float), dev))
    I = (lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev))
    prob = RigBAProblem(
        snap_idx=I(snap_idx), cam_idx=I(cam_idx), pt_idx=I(pt_idx),
        obs_xy=T(np.asarray(obs_xy, float).reshape(-1, 2)),
        focal=T([focal.get(k, 1.0) for k in range(C)]),
        pp=T([pp.get(k, (0.0, 0.0)) for k in range(C)]),
        rig_q=T(np.stack([s[2] for s in snaps])),
        rig_t=T(np.stack([s[3] for s in snaps])),
        mount_q=T(np.stack(mount_q)), mount_t=T(np.stack(mount_t)),
        points=T(np.stack([rec.points3D[p].xyz for p in pt_ids])))
    return prob, {"snaps": snaps, "mount_key": mount_key, "pt_ids": pt_ids}


def apply_rig_ba_result(rec, rigs: list, out, meta) -> None:
    """Write a RigBAResult back: the rigs' mounts, every snapshot image's
    pose (its mount ∘ the snapshot's rig pose) and the points."""
    host = (lambda a: a.detach().cpu().numpy())
    mq, mt = host(out.mount_q), host(out.mount_t)
    rq, rt, X = host(out.rig_q), host(out.rig_t), host(out.points)
    for key, midx in meta["mount_key"].items():
        if key[0] == "free":
            continue
        ridx, cid = key
        rigs[ridx].cam_from_rig_q[cid] = mq[midx]
        rigs[ridx].cam_from_rig_t[cid] = mt[midx]
    for sidx, (ims, ridx, _, _) in enumerate(meta["snaps"]):
        for iid in ims:
            cid = rec.images[iid].camera_id
            if ridx is not None:
                q, t = rigs[ridx].image_pose(cid, rq[sidx], rt[sidx])
            else:
                midx = meta["mount_key"][("free", cid)]
                q, t = _compose(mq[midx], mt[midx], rq[sidx], rt[sidx])
            rec.images[iid].qvec = q
            rec.images[iid].tvec = t
    for k, pid in enumerate(meta["pt_ids"]):
        rec.points3D[pid].xyz = X[k]
