"""ctypes bindings for the native graph core (native/graphcore.cpp).

Port of dagsfm_tpu/graph/native.py. It loads the committed
native/build/libgraphcore.so as it is and never builds it; where the
library cannot be loaded, every entry point has its pure-Python path,
and `ncut` falls back to the port's spectral clustering.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from dagsfm_tpu_torch import device as devmod

_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SO = os.path.join(_ROOT, "native", "build", "libgraphcore.so")


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64, f_i = ctypes.c_int64, ctypes.c_int32
    sigs = {
        "gc_connected_components": [i64, i64, i64p, i64p],
        "gc_largest_cc": [i64, i64, i64p, u8p],
        "gc_kruskal": [i64, i64, i64p, f64p, f_i, i64p],
        "gc_triangles": [i64, i64, i64p, i64p, i64],
        "gc_cnm_communities": [i64, i64, i64p, f64p, i64p],
        "gc_ncut": [i64, i64, i64p, f64p, i64, ctypes.c_uint64, i64p],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = args
    _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype=ctypes.c_int64):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _as_i64(a):
    return np.ascontiguousarray(a, np.int64)


def available() -> bool:
    return _load() is not None


def connected_components(num_nodes: int, edges: np.ndarray) -> np.ndarray:
    lib = _load()
    edges = _as_i64(edges)
    if lib is not None:
        labels = np.empty(num_nodes, np.int64)
        lib.gc_connected_components(num_nodes, len(edges), _ptr(edges),
                                    _ptr(labels))
        return labels
    from dagsfm_tpu_torch.graph.view_graph import UnionFind
    uf = UnionFind(num_nodes)
    for (i, j) in edges:
        uf.union(int(i), int(j))
    remap: dict = {}
    labels = np.empty(num_nodes, np.int64)
    for v in range(num_nodes):
        labels[v] = remap.setdefault(uf.find(v), len(remap))
    return labels


def largest_cc_mask(num_nodes: int, edges: np.ndarray) -> np.ndarray:
    lib = _load()
    edges = _as_i64(edges)
    if lib is not None:
        mask = np.empty(num_nodes, np.uint8)
        lib.gc_largest_cc(num_nodes, len(edges), _ptr(edges),
                          _ptr(mask, ctypes.c_uint8))
        return mask.astype(bool)
    labels = connected_components(num_nodes, edges)
    return labels == np.argmax(np.bincount(labels))


def kruskal(num_nodes: int, edges: np.ndarray, weights: np.ndarray,
            maximize: bool = False) -> np.ndarray:
    lib = _load()
    edges = _as_i64(edges)
    weights = np.ascontiguousarray(weights, np.float64)
    if lib is not None:
        out = np.empty(len(edges), np.int64)
        k = lib.gc_kruskal(num_nodes, len(edges), _ptr(edges),
                           _ptr(weights, ctypes.c_double),
                           1 if maximize else 0, _ptr(out))
        return out[:k]
    from dagsfm_tpu_torch.graph.view_graph import UnionFind
    order = np.argsort(-weights if maximize else weights, kind="stable")
    uf = UnionFind(num_nodes)
    out = []
    for e in order:
        i, j = int(edges[e, 0]), int(edges[e, 1])
        if uf.find(i) != uf.find(j):
            uf.union(i, j)
            out.append(e)
    return np.array(out, np.int64)


def triangles(num_nodes: int, edges: np.ndarray,
              max_out: int = 2_000_000) -> np.ndarray:
    lib = _load()
    edges = _as_i64(edges)
    if lib is not None:
        out = np.empty((max_out, 3), np.int64)
        k = lib.gc_triangles(num_nodes, len(edges), _ptr(edges), _ptr(out),
                             max_out)
        return out[:k]
    adj: dict[int, set] = {}
    for (i, j) in edges:
        adj.setdefault(int(i), set()).add(int(j))
        adj.setdefault(int(j), set()).add(int(i))
    tris = set()
    for (i, j) in edges:
        i, j = int(i), int(j)
        for k in adj.get(i, set()) & adj.get(j, set()):
            tris.add(tuple(sorted((i, j, k))))
    return np.array(sorted(tris), np.int64).reshape(-1, 3)


def ncut(num_nodes: int, edges: np.ndarray, weights: np.ndarray,
         num_parts: int, seed: int = 0, device=None) -> np.ndarray:
    """Multilevel normalized cut (the native Graclus-style kernel
    k-means). Without the library: the port's spectral relaxation on
    `device` (the GPU unless told "cpu")."""
    dev = devmod.resolve(device)
    lib = _load()
    edges = _as_i64(edges)
    weights = np.ascontiguousarray(weights, np.float64)
    if lib is not None:
        labels = np.empty(num_nodes, np.int64)
        lib.gc_ncut(num_nodes, len(edges), _ptr(edges),
                    _ptr(weights, ctypes.c_double), num_parts, seed,
                    _ptr(labels))
        return labels
    from dagsfm_tpu_torch.clustering.spectral import spectral_cluster
    return spectral_cluster(edges.astype(np.int32), weights, num_nodes,
                            num_parts, seed=seed,
                            device=dev).astype(np.int64)


def cnm_communities(num_nodes: int, edges: np.ndarray,
                    weights: np.ndarray) -> np.ndarray:
    lib = _load()
    edges = _as_i64(edges)
    weights = np.ascontiguousarray(weights, np.float64)
    if lib is not None:
        labels = np.empty(num_nodes, np.int64)
        lib.gc_cnm_communities(num_nodes, len(edges), _ptr(edges),
                               _ptr(weights, ctypes.c_double), _ptr(labels))
        return labels
    from dagsfm_tpu_torch.clustering.community import community_detection
    return community_detection(edges.astype(np.int32), weights,
                               num_nodes).astype(np.int64)
