"""Model exporters and importers: NVM (VisualSfM), Bundler, and the PMVS /
CMP-MVS undistorter workspace layouts.

Port of dagsfm_tpu/scene/exporters.py; host text writers that write the
reference's bytes (the same formatting of the same float64 values).

Conventions:
  NVM_V3: per camera `name f qw qx qy qz cx cy cz r 0` where (qw..qz) is
  the world-to-cam rotation and c = -Rᵀt the camera center; measurements
  are center-origin pixel coords.
  Bundler v0.3: camera looks down -z, so rows 1-2 of R and components
  1-2 of t are negated vs COLMAP; keypoints center-origin with +y up.
"""

from __future__ import annotations

import os

import numpy as np

from dagsfm_tpu_torch.ops import rotations as rops
from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene.reconstruction import ImageRecord, Reconstruction


def _center(qvec, tvec):
    R = rops.quat_to_rotmat_np(qvec)
    return -R.T @ np.asarray(tvec, float), R


def write_nvm(rec: Reconstruction, path: str) -> None:
    """Export to VisualSfM NVM_V3 (ref reconstruction.cc ExportNVM)."""
    reg = rec.reg_image_ids
    idx_of = {iid: k for k, iid in enumerate(reg)}
    lines = ["NVM_V3", "", str(len(reg))]
    for iid in reg:
        im = rec.images[iid]
        cam = rec.cameras[im.camera_id]
        c, _ = _center(im.qvec, im.tvec)
        f = cam.focal()
        # radial distortion if the model has one leading k (SIMPLE_RADIAL)
        k = float(cam.params[3]) if cam.model_name == "SIMPLE_RADIAL" else 0.0
        q = im.qvec
        lines.append(f"{im.name} {f} {q[0]} {q[1]} {q[2]} {q[3]} "
                     f"{c[0]} {c[1]} {c[2]} {k} 0")
    pts = sorted(rec.points3D.items())
    lines.append(str(len(pts)))
    for _, pt in pts:
        meas = []
        for (iid, kp) in pt.track:
            if iid not in idx_of:
                continue
            im = rec.images[iid]
            K = rec.cameras[im.camera_id].calibration_matrix()
            u = im.xys[kp][0] - K[0, 2]
            v = im.xys[kp][1] - K[1, 2]
            meas.append(f"{idx_of[iid]} {kp} {u} {v}")
        col = pt.color
        lines.append(f"{pt.xyz[0]} {pt.xyz[1]} {pt.xyz[2]} "
                     f"{col[0]} {col[1]} {col[2]} {len(meas)} "
                     + " ".join(meas))
    lines += ["", "0", "", "0"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_nvm(path: str) -> Reconstruction:
    """Import NVM_V3 (enough to round-trip write_nvm)."""
    with open(path) as f:
        toks = f.read().split("\n")
    assert toks[0].startswith("NVM_V3")
    i = 1
    while not toks[i].strip():
        i += 1
    n_cams = int(toks[i]); i += 1
    rec = Reconstruction()
    names = []
    for k in range(n_cams):
        parts = toks[i].split(); i += 1
        name, f = parts[0], float(parts[1])
        q = np.asarray([float(x) for x in parts[2:6]])
        c = np.asarray([float(x) for x in parts[6:9]])
        R = rops.quat_to_rotmat_np(q)
        t = -R @ c
        cam = cm.Camera(camera_id=k, model_id=cm.CAMERA_MODEL_IDS[
            "SIMPLE_PINHOLE"], width=0, height=0,
            params=(f, 0.0, 0.0))
        rec.add_camera(cam)
        rec.add_image(ImageRecord(
            image_id=k, name=name, camera_id=k, qvec=q, tvec=t,
            xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64)))
        rec.register_image(k)
        names.append(name)
    n_pts = int(toks[i]); i += 1
    kp_store = {k: {} for k in range(n_cams)}
    raw_pts = []
    for _ in range(n_pts):
        parts = toks[i].split(); i += 1
        xyz = np.asarray([float(x) for x in parts[:3]])
        col = np.asarray([int(float(x)) for x in parts[3:6]], np.uint8)
        m = int(parts[6])
        track = []
        for j in range(m):
            ci = int(parts[7 + 4 * j])
            kp = int(parts[8 + 4 * j])
            u = float(parts[9 + 4 * j]); v = float(parts[10 + 4 * j])
            kp_store[ci][kp] = (u, v)
            track.append((ci, kp))
        raw_pts.append((xyz, col, track))
    # materialize per-image keypoint arrays (center-origin -> principal 0)
    for k in range(n_cams):
        if kp_store[k]:
            mx = max(kp_store[k]) + 1
            xys = np.zeros((mx, 2))
            for kp, (u, v) in kp_store[k].items():
                xys[kp] = (u, v)
            rec.images[k].xys = xys
            rec.images[k].point3D_ids = np.full(mx, -1, np.int64)
    for xyz, col, track in raw_pts:
        rec.add_point3D(xyz, track, color=col)
    return rec


def write_bundler(rec: Reconstruction, path: str,
                  list_path: str | None = None) -> None:
    """Export Bundler bundle.out + image list (ref ExportBundler)."""
    reg = rec.reg_image_ids
    idx_of = {iid: k for k, iid in enumerate(reg)}
    pts = sorted(rec.points3D.items())
    lines = ["# Bundle file v0.3", f"{len(reg)} {len(pts)}"]
    flip = np.diag([1.0, -1.0, -1.0])
    for iid in reg:
        im = rec.images[iid]
        cam = rec.cameras[im.camera_id]
        R = flip @ rops.quat_to_rotmat_np(im.qvec)
        t = flip @ np.asarray(im.tvec, float)
        k1 = float(cam.params[3]) if cam.model_name == "SIMPLE_RADIAL" \
            else 0.0
        lines.append(f"{cam.focal()} {k1} 0")
        for r in range(3):
            lines.append(f"{R[r, 0]} {R[r, 1]} {R[r, 2]}")
        lines.append(f"{t[0]} {t[1]} {t[2]}")
    for _, pt in pts:
        lines.append(f"{pt.xyz[0]} {pt.xyz[1]} {pt.xyz[2]}")
        lines.append(f"{pt.color[0]} {pt.color[1]} {pt.color[2]}")
        meas = []
        for (iid, kp) in pt.track:
            if iid not in idx_of:
                continue
            im = rec.images[iid]
            K = rec.cameras[im.camera_id].calibration_matrix()
            u = im.xys[kp][0] - K[0, 2]
            v = -(im.xys[kp][1] - K[1, 2])        # bundler: +y up
            meas.append(f"{idx_of[iid]} {kp} {u} {v}")
        lines.append(f"{len(meas)} " + " ".join(meas))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if list_path:
        with open(list_path, "w") as f:
            for iid in reg:
                f.write(rec.images[iid].name + "\n")


def write_pmvs_workspace(rec: Reconstruction, workspace: str) -> None:
    """PMVS option/projection layout (ref PMVSUndistorter::Run writes
    txt/%08d.txt P-matrices, vis.dat, option-all). Undistorted images are
    produced by scene/undistortion.py; this emits the metadata."""
    os.makedirs(os.path.join(workspace, "txt"), exist_ok=True)
    os.makedirs(os.path.join(workspace, "visualize"), exist_ok=True)
    os.makedirs(os.path.join(workspace, "models"), exist_ok=True)
    reg = rec.reg_image_ids
    idx_of = {iid: k for k, iid in enumerate(reg)}
    for iid in reg:
        im = rec.images[iid]
        K = rec.cameras[im.camera_id].calibration_matrix()
        R = rops.quat_to_rotmat_np(im.qvec)
        P = K @ np.hstack([R, np.asarray(im.tvec, float)[:, None]])
        with open(os.path.join(workspace, "txt",
                               f"{idx_of[iid]:08d}.txt"), "w") as f:
            f.write("CONTOUR\n")
            for r in range(3):
                f.write(f"{P[r, 0]} {P[r, 1]} {P[r, 2]} {P[r, 3]}\n")
    # vis.dat: per-image covisibility from shared 3D points
    vis = {k: set() for k in range(len(reg))}
    for _, pt in rec.points3D.items():
        ks = [idx_of[i] for i, _ in pt.track if i in idx_of]
        for a in ks:
            for b in ks:
                if a != b:
                    vis[a].add(b)
    with open(os.path.join(workspace, "vis.dat"), "w") as f:
        f.write(f"VISDATA\n{len(reg)}\n")
        for k in range(len(reg)):
            n = sorted(vis[k])
            f.write(f"{k} {len(n)} " + " ".join(map(str, n)) + "\n")
    with open(os.path.join(workspace, "option-all"), "w") as f:
        f.write("level 1\ncsize 2\nthreshold 0.7\nwsize 7\n"
                "minImageNum 3\nCPU 4\nuseVisData 1\nsequence -1\n"
                f"timages -1 0 {len(reg)}\noimages 0\n")


def write_cmpmvs_workspace(rec: Reconstruction, workspace: str) -> None:
    """CMP-MVS layout: per-image P-matrix `<n>_P.txt` (ref
    CMPMVSUndistorter::Run)."""
    os.makedirs(workspace, exist_ok=True)
    for k, iid in enumerate(rec.reg_image_ids):
        im = rec.images[iid]
        K = rec.cameras[im.camera_id].calibration_matrix()
        R = rops.quat_to_rotmat_np(im.qvec)
        P = K @ np.hstack([R, np.asarray(im.tvec, float)[:, None]])
        with open(os.path.join(workspace, f"{k + 1:05d}_P.txt"), "w") as f:
            f.write("CONTOUR\n")
            for r in range(3):
                f.write(f"{P[r, 0]} {P[r, 1]} {P[r, 2]} {P[r, 3]}\n")
