"""ctypes bindings for the native graph-builder library (port's own copy of
``occlusionfusion_tpu/graph/native.py``).

``csrc/graph_builder.cpp`` holds the sequential host ops that run only at
keyframes: mesh erosion, greedy node sampling, Dijkstra geodesic edges,
connected components and marching cubes. It is built with ``g++`` at
first use into the package's git-ignored ``_build/`` directory and
rebuilt when the source is newer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from occlusionfusion_tpu_torch.device import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "graph_builder.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libgraph_builder.so")
_lib = None


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    subprocess.run(
        ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
         "-Wall", _SRC, "-o", tmp],
        check=True,
    )
    os.replace(tmp, _LIB_PATH)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.erode_mesh.restype = None
    lib.erode_mesh.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p,
    ]
    lib.sample_nodes.restype = ctypes.c_int
    lib.sample_nodes.argtypes = [
        f32p, u8p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int64, i32p,
    ]
    lib.geodesic_edges.restype = None
    lib.geodesic_edges.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, i32p, f32p,
    ]
    lib.compute_clusters.restype = ctypes.c_int
    lib.compute_clusters.argtypes = [i32p, ctypes.c_int, ctypes.c_int, i32p, i32p]
    lib.marching_cubes.restype = ctypes.c_int
    lib.marching_cubes.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_float,
        f32p, ctypes.c_int, i32p, ctypes.c_int, i32p,
    ]
    _lib = lib
    return lib


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def erode_mesh(vertices, faces, iterations: int = 4, min_neighbors: int = 4):
    """Boolean keep-mask per vertex (True = survives erosion)."""
    lib = _load()
    v = _f32(vertices)
    f = _i32(faces)
    out = np.zeros((v.shape[0],), np.uint8)
    lib.erode_mesh(
        _ptr(v, ctypes.c_float), v.shape[0], _ptr(f, ctypes.c_int32),
        f.shape[0], iterations, min_neighbors, _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


def sample_nodes(vertices, vertex_valid, node_coverage: float,
                 max_nodes: int = 4096, seed: int = -1):
    """Greedy coverage sampling; vertex ids of the chosen nodes."""
    lib = _load()
    v = _f32(vertices)
    valid = (
        np.ascontiguousarray(vertex_valid, np.uint8)
        if vertex_valid is not None
        else np.ones((v.shape[0],), np.uint8)
    )
    out = np.empty((max_nodes,), np.int32)
    n = lib.sample_nodes(
        _ptr(v, ctypes.c_float), _ptr(valid, ctypes.c_uint8), v.shape[0],
        ctypes.c_float(node_coverage), max_nodes, seed,
        _ptr(out, ctypes.c_int32),
    )
    return out[:n].copy()


def geodesic_edges(vertices, faces, node_ids, k: int = 8,
                   max_influence: float = 0.0):
    """Per-node k nearest nodes by geodesic distance: (edges [N, k] int32
    (-1 pad), dists [N, k] f32 (inf pad))."""
    lib = _load()
    v = _f32(vertices)
    f = _i32(faces)
    ids = _i32(node_ids)
    n = ids.shape[0]
    edges = np.empty((n, k), np.int32)
    dists = np.empty((n, k), np.float32)
    lib.geodesic_edges(
        _ptr(v, ctypes.c_float), v.shape[0], _ptr(f, ctypes.c_int32),
        f.shape[0], _ptr(ids, ctypes.c_int32), n, k,
        ctypes.c_float(max_influence), _ptr(edges, ctypes.c_int32),
        _ptr(dists, ctypes.c_float),
    )
    return edges, dists


def compute_clusters(edges: np.ndarray):
    """Connected components over [N, k] edge lists (-1 padded):
    (cluster_id [N] int32, sizes [C])."""
    lib = _load()
    e = _i32(edges)
    n, k = e.shape
    cluster = np.empty((n,), np.int32)
    sizes = np.empty((n,), np.int32)
    c = lib.compute_clusters(
        _ptr(e, ctypes.c_int32), n, k, _ptr(cluster, ctypes.c_int32),
        _ptr(sizes, ctypes.c_int32),
    )
    return cluster, sizes[:c].copy()


def marching_cubes(volume: np.ndarray, mask: np.ndarray | None = None,
                   iso: float = 0.0):
    """Iso-surface of a [X, Y, Z] volume: (vertices [V, 3] in voxel
    units, faces [F, 3]); the optional uint8 cell mask restricts it to
    observed cells."""
    lib = _load()
    vol = _f32(volume)
    X, Y, Z = vol.shape
    m = None
    mp = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    if mask is not None:
        m = np.ascontiguousarray(mask, np.uint8)
        mp = _ptr(m, ctypes.c_uint8)
    cap_v = 4 * X * Y * Z // 2 + 1024
    cap_f = 4 * X * Y * Z + 2048
    verts = np.empty((cap_v, 3), np.float32)
    faces = np.empty((cap_f, 3), np.int32)
    nf = ctypes.c_int32(0)
    nv = lib.marching_cubes(
        _ptr(vol, ctypes.c_float), X, Y, Z, mp, ctypes.c_float(iso),
        _ptr(verts, ctypes.c_float), cap_v, _ptr(faces, ctypes.c_int32),
        cap_f, ctypes.byref(nf),
    )
    return verts[:nv].copy(), faces[: nf.value].copy()
