"""COLMAP binary model I/O (cameras.bin, images.bin, points3D.bin).

Port of the binary half of dagsfm_tpu/scene/io.py; the files are
byte-identical to the reference's for the same Reconstruction. Text, PLY
and the SQLite database wait.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene.reconstruction import (ImageRecord, Point3DRecord,
                                                   Reconstruction)


def _read(fid, fmt):
    return struct.unpack(fmt, fid.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> dict:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            params = _read(f, f"<{cm.CAMERA_MODEL_NUM_PARAMS[model_id]}d")
            cameras[cam_id] = cm.Camera(cam_id, model_id, int(w), int(h),
                                        tuple(params))
    return cameras


def write_cameras_bin(cameras: dict, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam_id in sorted(cameras):
            c = cameras[cam_id]
            f.write(struct.pack("<iiQQ", c.camera_id, c.model_id, c.width,
                                c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def read_images_bin(path: str) -> dict:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            image_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            camera_id = _read(f, "<i")[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (num_pts,) = _read(f, "<Q")
            xys = np.zeros((num_pts, 2))
            pids = np.full(num_pts, -1, np.int64)
            for k in range(num_pts):
                xys[k] = _read(f, "<2d")
                (pids[k],) = _read(f, "<q")
            images[image_id] = ImageRecord(
                image_id=image_id, name=name.decode(), camera_id=camera_id,
                qvec=qvec, tvec=tvec, xys=xys, point3D_ids=pids,
                registered=True)
    return images


def write_images_bin(images: dict, path: str) -> None:
    with open(path, "wb") as f:
        reg = {i: im for i, im in images.items() if im.registered}
        f.write(struct.pack("<Q", len(reg)))
        for image_id in sorted(reg):
            im = reg[image_id]
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *np.asarray(im.qvec, float)))
            f.write(struct.pack("<3d", *np.asarray(im.tvec, float)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for k in range(len(im.xys)):
                f.write(struct.pack("<2d", im.xys[k, 0], im.xys[k, 1]))
                f.write(struct.pack("<q", int(im.point3D_ids[k])))


def read_points3D_bin(path: str) -> dict:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (pid,) = _read(f, "<Q")
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"), np.uint8)
            (error,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = [tuple(int(v) for v in _read(f, "<ii"))
                     for _k in range(track_len)]
            points[int(pid)] = (xyz, rgb, float(error), track)
    return points


def write_points3D_bin(points3D: dict, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points3D)))
        for pid in sorted(points3D):
            pt = points3D[pid]
            f.write(struct.pack("<Q", pid))
            f.write(struct.pack("<3d", *np.asarray(pt.xyz, float)))
            f.write(struct.pack("<3B", *np.asarray(pt.color, np.uint8)))
            f.write(struct.pack("<d", float(pt.error)))
            f.write(struct.pack("<Q", len(pt.track)))
            for (img_id, p2d) in pt.track:
                f.write(struct.pack("<ii", img_id, p2d))


def write_model_bin(rec: Reconstruction, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    write_cameras_bin(rec.cameras, os.path.join(path, "cameras.bin"))
    write_images_bin(rec.images, os.path.join(path, "images.bin"))
    write_points3D_bin(rec.points3D, os.path.join(path, "points3D.bin"))


def read_model_bin(path: str) -> Reconstruction:
    rec = Reconstruction()
    rec.cameras = read_cameras_bin(os.path.join(path, "cameras.bin"))
    rec.images = read_images_bin(os.path.join(path, "images.bin"))
    raw = read_points3D_bin(os.path.join(path, "points3D.bin"))
    for pid, (xyz, rgb, err, track) in raw.items():
        rec.points3D[pid] = Point3DRecord(xyz, rgb, err, track)
    rec._next_point3D_id = max(rec.points3D, default=0) + 1
    return rec
