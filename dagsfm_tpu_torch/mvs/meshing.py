"""Surface meshing from fused dense points.

Port of dagsfm_tpu/mvs/meshing.py: Delaunay meshing through scipy.spatial
on the host (a 3D Delaunay tetrahedralization's boundary faces, dropping
faces with edges much longer than the median point spacing) and the
binary PLY mesh writer. The reference's Python loops (the boundary-face
dictionary, the per-triangle bytes) are numpy array operations here,
with the same face order and the same bytes.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

_FACES = np.array([(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)])


class MeshingOptions(NamedTuple):
    max_edge_factor: float = 3.0   # edge <= factor * median point spacing
    min_triangles: int = 1


def _boundary_faces(simplices: np.ndarray, n: int) -> np.ndarray:
    """The faces (vertex ids ascending) that belong to exactly one
    tetrahedron, in the order the tetrahedra list them."""
    faces = np.sort(simplices[:, _FACES].reshape(-1, 3).astype(np.int64),
                    axis=1)
    if float(n) ** 3 < 2.0 ** 62:
        key = (faces[:, 0] * n + faces[:, 1]) * n + faces[:, 2]
        _, inverse, counts = np.unique(key, return_inverse=True,
                                       return_counts=True)
    else:
        _, inverse, counts = np.unique(faces, axis=0, return_inverse=True,
                                       return_counts=True)
    return faces[counts[inverse] == 1]


def delaunay_mesh(xyz: np.ndarray,
                  opts: MeshingOptions = MeshingOptions()) -> tuple:
    """Point cloud -> (vertices (N, 3), triangles (M, 3) int): the boundary
    faces of the 3D Delaunay tetrahedralization whose longest edge is at
    most max_edge_factor times the median nearest-neighbour spacing."""
    from scipy.spatial import Delaunay, cKDTree

    xyz = np.asarray(xyz, np.float64)
    if len(xyz) < 4:
        return xyz, np.zeros((0, 3), np.int64)
    surface = _boundary_faces(Delaunay(xyz).simplices, len(xyz))

    d, _ = cKDTree(xyz).query(xyz, k=2)
    lim = opts.max_edge_factor * np.median(d[:, 1])
    a, b, c = xyz[surface[:, 0]], xyz[surface[:, 1]], xyz[surface[:, 2]]
    emax = np.maximum(np.linalg.norm(a - b, axis=1),
                      np.maximum(np.linalg.norm(b - c, axis=1),
                                 np.linalg.norm(a - c, axis=1)))
    return xyz, surface[emax <= lim]


def write_ply_mesh(path: str, vertices: np.ndarray,
                   triangles: np.ndarray) -> None:
    """Mesh -> binary PLY: float vertices, then per face a count byte (3)
    and three int32 vertex ids."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    v = np.asarray(vertices, "<f4")
    t = np.asarray(triangles, "<i4")
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(v)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(t)}\n"
              "property list uchar int vertex_index\nend_header\n")
    faces = np.empty(len(t), np.dtype([("n", "u1"), ("v", "<i4", 3)]))
    faces["n"] = 3
    faces["v"] = t.reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(v.tobytes())
        f.write(faces.tobytes())
