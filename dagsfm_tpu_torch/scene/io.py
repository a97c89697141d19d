"""COLMAP model I/O (.bin, .txt, .ply) and the COLMAP SQLite database.

Port of dagsfm_tpu/scene/io.py: the model files are byte-identical to the
reference's for the same Reconstruction, and the database has COLMAP's
schema (base/database.cc) with the same rows, blob for blob. Pair ids pack
two image ids into one Python int (`image_id1 * MAX_IMAGE_ID +
image_id2`, past 2^31), never through a fixed-width integer.
"""

from __future__ import annotations

import os
import sqlite3
import struct

import numpy as np

from dagsfm_tpu_torch.scene import cameras as cm
from dagsfm_tpu_torch.scene.reconstruction import (ImageRecord, Point3DRecord,
                                                   Reconstruction)

# pair_id packing (COLMAP base/database.h)
MAX_IMAGE_ID = 2147483647


def pair_id_from_image_ids(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return int(image_id1) * MAX_IMAGE_ID + int(image_id2)


def image_ids_from_pair_id(pair_id: int) -> tuple:
    pair_id = int(pair_id)
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


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


# ---------------------------------------------------------------------------
# Text model format
# ---------------------------------------------------------------------------

def write_model_text(rec: Reconstruction, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(rec.cameras)}\n")
        for cid in sorted(rec.cameras):
            c = rec.cameras[cid]
            params = " ".join(repr(float(p)) for p in c.params)
            f.write(f"{c.camera_id} {c.model_name} {c.width} {c.height} "
                    f"{params}\n")
    with open(os.path.join(path, "images.txt"), "w") as f:
        reg = [im for im in rec.images.values() if im.registered]
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(reg)}\n")
        for im in sorted(reg, key=lambda im: im.image_id):
            q = [float(v) for v in im.qvec]
            t = [float(v) for v in im.tvec]
            f.write(f"{im.image_id} {q[0]!r} {q[1]!r} {q[2]!r} {q[3]!r} "
                    f"{t[0]!r} {t[1]!r} {t[2]!r} {im.camera_id} {im.name}\n")
            parts = []
            for k in range(len(im.xys)):
                parts.append(f"{float(im.xys[k, 0])!r} {float(im.xys[k, 1])!r} "
                             f"{int(im.point3D_ids[k])}")
            f.write(" ".join(parts) + "\n")
    with open(os.path.join(path, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(rec.points3D)}\n")
        for pid in sorted(rec.points3D):
            pt = rec.points3D[pid]
            track = " ".join(f"{i} {k}" for (i, k) in pt.track)
            x = [float(v) for v in pt.xyz]
            f.write(f"{pid} {x[0]!r} {x[1]!r} {x[2]!r} "
                    f"{pt.color[0]} {pt.color[1]} {pt.color[2]} "
                    f"{float(pt.error)!r} {track}\n")


def read_model_text(path: str) -> Reconstruction:
    rec = Reconstruction()
    with open(os.path.join(path, "cameras.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            cid, model, w, h = int(toks[0]), toks[1], int(toks[2]), int(toks[3])
            params = tuple(float(x) for x in toks[4:])
            rec.cameras[cid] = cm.Camera(cid, cm.CAMERA_MODEL_IDS[model],
                                         w, h, params)
    with open(os.path.join(path, "images.txt")) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for a in range(0, len(lines), 2):
        toks = lines[a].split()
        image_id = int(toks[0])
        qvec = np.array([float(x) for x in toks[1:5]])
        tvec = np.array([float(x) for x in toks[5:8]])
        camera_id = int(toks[8])
        name = toks[9]
        pts = lines[a + 1].split() if a + 1 < len(lines) else []
        n = len(pts) // 3
        xys = np.zeros((n, 2))
        pids = np.full(n, -1, np.int64)
        for k in range(n):
            xys[k] = (float(pts[3 * k]), float(pts[3 * k + 1]))
            pids[k] = int(pts[3 * k + 2])
        rec.images[image_id] = ImageRecord(
            image_id=image_id, name=name, camera_id=camera_id, qvec=qvec,
            tvec=tvec, xys=xys, point3D_ids=pids, registered=True)
    with open(os.path.join(path, "points3D.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            pid = int(toks[0])
            xyz = np.array([float(x) for x in toks[1:4]])
            rgb = np.array([int(x) for x in toks[4:7]], np.uint8)
            err = float(toks[7])
            rest = toks[8:]
            track = [(int(rest[2 * k]), int(rest[2 * k + 1]))
                     for k in range(len(rest) // 2)]
            rec.points3D[pid] = Point3DRecord(xyz, rgb, err, track)
    rec._next_point3D_id = max(rec.points3D, default=0) + 1
    return rec


def write_model_ply(rec: Reconstruction, path: str) -> None:
    """Sparse point cloud as ASCII PLY, points in id order (COLMAP's
    Reconstruction::ExportPLY)."""
    pts = sorted(rec.points3D.items())
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n")
        for _, pt in pts:
            f.write(f"{pt.xyz[0]} {pt.xyz[1]} {pt.xyz[2]} "
                    f"{pt.color[0]} {pt.color[1]} {pt.color[2]}\n")


# ---------------------------------------------------------------------------
# COLMAP SQLite database
# ---------------------------------------------------------------------------

_DB_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB);
"""


class ColmapDatabase:
    """COLMAP-schema SQLite database (COLMAP base/database.{h,cc}).

    The feature pipeline's checkpoint store: a database that holds
    two-view geometries lets a re-run skip extraction, matching and
    verification (`FeaturePipeline.run`).
    """

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_DB_SCHEMA)

    def close(self):
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # ------------------------------------------------------------- cameras
    def add_camera(self, camera: cm.Camera):
        params = np.asarray(camera.params, np.float64).tobytes()
        self.conn.execute(
            "INSERT OR REPLACE INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (int(camera.camera_id), int(camera.model_id), int(camera.width),
             int(camera.height), params, int(camera.prior_focal)))

    def read_cameras(self) -> dict:
        out = {}
        for cid, model, w, h, blob, prior in self.conn.execute(
                "SELECT * FROM cameras"):
            params = tuple(np.frombuffer(blob, np.float64).tolist())
            out[cid] = cm.Camera(cid, model, w, h, params,
                                 prior_focal=bool(prior))
        return out

    # -------------------------------------------------------------- images
    def add_image(self, name: str, camera_id: int, image_id=None,
                  prior_qvec=None, prior_tvec=None) -> int:
        pq = ([None] * 4 if prior_qvec is None
              else [float(x) for x in prior_qvec])
        pt = ([None] * 3 if prior_tvec is None
              else [float(x) for x in prior_tvec])
        cur = self.conn.execute(
            "INSERT OR REPLACE INTO images VALUES (?,?,?,?,?,?,?,?,?,?)",
            (None if image_id is None else int(image_id), name,
             int(camera_id), *pq, *pt))
        return cur.lastrowid

    def read_images(self) -> dict:
        return {row[0]: (row[1], row[2]) for row in self.conn.execute(
            "SELECT image_id, name, camera_id FROM images")}

    def read_image_priors(self) -> dict:
        """image_id -> prior_tvec (3,) for images with location priors
        (what COLMAP's spatial matcher reads)."""
        out = {}
        for iid, tx, ty, tz in self.conn.execute(
                "SELECT image_id, prior_tx, prior_ty, prior_tz "
                "FROM images"):
            if tx is not None and ty is not None and tz is not None:
                out[iid] = np.array([tx, ty, tz], float)
        return out

    # ----------------------------------------------------------- keypoints
    def add_keypoints(self, image_id: int, xys: np.ndarray):
        # float32 rows; 2-column input is stored as (x, y, 1, 0), as the
        # reference stores it
        kp = np.asarray(xys, np.float32)
        if kp.shape[1] == 2:
            kp = np.concatenate(
                [kp, np.ones((len(kp), 1), np.float32),
                 np.zeros((len(kp), 1), np.float32)], axis=1)
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            (int(image_id), kp.shape[0], kp.shape[1], kp.tobytes()))

    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,)).fetchone()
        if row is None:
            return np.zeros((0, 2), np.float32)
        r, c, blob = row
        return np.frombuffer(blob, np.float32).reshape(r, c)

    def add_descriptors(self, image_id: int, desc: np.ndarray):
        d = np.asarray(desc, np.uint8)
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
            (int(image_id), d.shape[0], d.shape[1], d.tobytes()))

    def read_descriptors(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id=?",
            (image_id,)).fetchone()
        if row is None:
            return np.zeros((0, 128), np.uint8)
        r, c, blob = row
        return np.frombuffer(blob, np.uint8).reshape(r, c)

    # ------------------------------------------------------------- matches
    def add_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        pid = pair_id_from_image_ids(image_id1, image_id2)
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        self.conn.execute(
            "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
            (pid, m.shape[0], 2, m.tobytes()))

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pid = pair_id_from_image_ids(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (pid,)).fetchone()
        if row is None:
            return np.zeros((0, 2), np.uint32)
        r, c, blob = row
        m = np.frombuffer(blob, np.uint32).reshape(r, c)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        return m

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              inlier_matches: np.ndarray, config: int = 2,
                              F=None, E=None, H=None):
        pid = pair_id_from_image_ids(image_id1, image_id2)
        m = np.asarray(inlier_matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        def b(x):
            return (np.asarray(x, np.float64).tobytes() if x is not None
                    else np.eye(3).tobytes())
        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries "
            "VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
            (pid, m.shape[0], 2, m.tobytes(), int(config), b(F), b(E),
             b(H)))

    def read_all_two_view_geometries(self):
        """Yield (image_id1, image_id2, matches, config, F, E, H) in
        pair_id order."""
        for pid, r, c, blob, config, F, E, H in self.conn.execute(
                "SELECT * FROM two_view_geometries ORDER BY pair_id"):
            i1, i2 = image_ids_from_pair_id(pid)
            m = (np.frombuffer(blob, np.uint32).reshape(r, c)
                 if blob and r else np.zeros((0, 2), np.uint32))
            yield (i1, i2, m, config,
                   np.frombuffer(F, np.float64).reshape(3, 3) if F else None,
                   np.frombuffer(E, np.float64).reshape(3, 3) if E else None,
                   np.frombuffer(H, np.float64).reshape(3, 3) if H else None)

    def num_two_view_geometries(self) -> int:
        return self.conn.execute(
            "SELECT COUNT(*) FROM two_view_geometries").fetchone()[0]

    @staticmethod
    def merge(db1: "ColmapDatabase", db2: "ColmapDatabase",
              out: "ColmapDatabase") -> dict:
        """Merge two databases into ``out`` (COLMAP Database::Merge): db1
        is copied verbatim; db2's cameras get fresh ids, its images keep
        their ids where free (an image whose name db1 holds keeps db1's
        id and is not duplicated); pair tables are renumbered. Returns
        the db2 -> out image-id map."""
        cam_map2: dict = {}
        img_map2: dict = {}
        for cid, cam in db1.read_cameras().items():
            out.add_camera(cam)
        name_to_out = {}
        for iid, (name, cid) in db1.read_images().items():
            out.add_image(name, cid, image_id=iid)
            name_to_out[name] = iid
            kp = db1.read_keypoints(iid)
            if len(kp):
                out.add_keypoints(iid, kp)
            de = db1.read_descriptors(iid)
            if len(de):
                out.add_descriptors(iid, de)
        next_cam = max(list(db1.read_cameras()) + [0]) + 1
        for cid, cam in db2.read_cameras().items():
            cam_map2[cid] = next_cam
            out.add_camera(cam._replace(camera_id=next_cam))
            next_cam += 1
        used_ids = set(name_to_out.values())
        for iid, (name, cid) in db2.read_images().items():
            if name in name_to_out:
                img_map2[iid] = name_to_out[name]
                continue
            # worker databases number images by the master's global ids,
            # so an id is kept unless it is taken
            keep = iid if iid not in used_ids else None
            new_id = out.add_image(name, cam_map2[cid], image_id=keep)
            used_ids.add(new_id)
            img_map2[iid] = new_id
            kp = db2.read_keypoints(iid)
            if len(kp):
                out.add_keypoints(new_id, kp)
            de = db2.read_descriptors(iid)
            if len(de):
                out.add_descriptors(new_id, de)
        for db, remap in ((db1, None), (db2, img_map2)):
            for pid, r, c, blob in db.conn.execute(
                    "SELECT * FROM matches"):
                i1, i2 = image_ids_from_pair_id(pid)
                if remap:
                    i1, i2 = remap[i1], remap[i2]
                m = (np.frombuffer(blob, np.uint32).reshape(r, c)
                     if blob and r else np.zeros((0, 2), np.uint32))
                out.add_matches(i1, i2, m)
            for i1, i2, m, config, F, E, H in \
                    db.read_all_two_view_geometries():
                if remap:
                    i1, i2 = remap[i1], remap[i2]
                    if i1 > i2:
                        i1, i2 = i2, i1
                        m = m[:, ::-1]
                out.add_two_view_geometry(i1, i2, m, config, F, E, H)
        out.conn.commit()
        return img_map2
