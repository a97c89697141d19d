"""MVS workspace I/O: COLMAP-compatible depth / normal map binaries and
PLY point clouds.

Port of dagsfm_tpu/mvs/io.py, the same bytes. COLMAP's `.bin` map format
is an ASCII header "<width>&<height>&<channels>&" followed by float32
data, channel-major, laid out under
<workspace>/stereo/{depth_maps,normal_maps}/<image>.<type>.bin. A
coloured PLY point cloud is written as one packed numpy record per point
(floats, then three colour bytes), not a loop over the points.
"""

from __future__ import annotations

import os

import numpy as np


def write_map_bin(path: str, data: np.ndarray) -> None:
    """(H, W) or (H, W, C) float map -> COLMAP .bin (mat.h Mat<float>)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[:, :, None]
    h, w, c = data.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        # COLMAP Mat<T> stores channel-major slices: data[y, x, c] at
        # offset c*W*H + y*W + x (mat.h Read/Write loops)
        f.write(np.ascontiguousarray(
            np.moveaxis(data, 2, 0)).tobytes())


def read_map_bin(path: str) -> np.ndarray:
    """COLMAP .bin map -> (H, W) float32 or (H, W, C)."""
    with open(path, "rb") as f:
        header = b""
        for _ in range(3):
            while True:
                ch = f.read(1)
                header += ch
                if ch == b"&":
                    break
        w, h, c = (int(t) for t in header.decode().split("&")[:3])
        data = np.frombuffer(f.read(), np.float32, count=w * h * c)
    data = np.moveaxis(data.reshape(c, h, w), 0, 2)
    return data[:, :, 0] if c == 1 else data


def depth_map_path(workspace: str, image_name: str,
                   kind: str = "geometric") -> str:
    return os.path.join(workspace, "stereo", "depth_maps",
                        f"{image_name}.{kind}.bin")


def normal_map_path(workspace: str, image_name: str,
                    kind: str = "geometric") -> str:
    return os.path.join(workspace, "stereo", "normal_maps",
                        f"{image_name}.{kind}.bin")


def write_ply_points(path: str, xyz: np.ndarray,
                     normal: np.ndarray | None = None,
                     color: np.ndarray | None = None) -> None:
    """Fused point cloud -> binary PLY (ref fusion output fused.ply)."""
    n = len(xyz)
    props = ["property float x", "property float y", "property float z"]
    cols = [np.asarray(xyz, np.float32)]
    if normal is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(np.asarray(normal, np.float32))
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {n}"] + props)
    if color is not None:
        col = np.asarray(color)
        if col.ndim == 1:
            col = np.repeat(col[:, None], 3, 1)
        col = np.clip(col * 255 if col.max() <= 1.0 else col,
                      0, 255).astype(np.uint8)
        header += ("\nproperty uchar red\nproperty uchar green\n"
                   "property uchar blue")
    header += "\nend_header\n"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flt = np.concatenate(cols, axis=1).astype("<f4")
    if color is not None:
        # one packed record per point: its floats, then its 3 colour bytes
        rows = np.empty(n, np.dtype([("f", "<f4", flt.shape[1]),
                                     ("c", "u1", 3)]))
        rows["f"] = flt
        rows["c"] = col
        flt = rows
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(flt.tobytes())


def read_ply_points(path: str):
    """Read a PLY point cloud -> (xyz (N,3), normals (N,3) | None).

    Counterpart of the reference mesher CLIs' fused.ply input
    (ref mvs/meshing.h PoissonMeshing(input_path)). Handles the binary
    little-endian and ascii layouts write_ply_points produces (float
    x/y/z [+ nx/ny/nz] [+ uchar rgb]).
    """
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = int(next(l.split()[2] for l in header
                     if l.startswith("element vertex")))
        props = [(l.split()[1], l.split()[2]) for l in header
                 if l.startswith("property")]
        names = [p[1] for p in props]
        np_types = {"float": "<f4", "double": "<f8", "uchar": "u1",
                    "uint8": "u1", "int": "<i4", "uint": "<u4"}
        if fmt.startswith("binary"):
            dtype = np.dtype([(nm, np_types[tp]) for tp, nm in props])
            data = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype)
        else:
            raw = np.loadtxt(f, max_rows=n)
            data = {nm: raw[:, k] for k, nm in enumerate(names)}
    xyz = np.stack([np.asarray(data["x"], np.float64),
                    np.asarray(data["y"], np.float64),
                    np.asarray(data["z"], np.float64)], axis=1)
    normals = None
    if all(k in names for k in ("nx", "ny", "nz")):
        normals = np.stack([np.asarray(data["nx"], np.float64),
                            np.asarray(data["ny"], np.float64),
                            np.asarray(data["nz"], np.float64)], axis=1)
    return xyz, normals
