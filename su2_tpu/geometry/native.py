"""ctypes binding for the native geometry core (native/libsu2_geom.so).

Falls back to None if the library hasn't been built; callers use the Python
builder then.  Build with `make -C native`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native",
        "libsu2_geom.so")
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.su2geom_build_dual_2d.restype = ctypes.c_int64
    lib.su2geom_build_dual_2d.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.su2geom_adjacency.restype = ctypes.c_int64
    lib.su2geom_adjacency.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_dual_2d(coords: np.ndarray, elem_types: np.ndarray,
                  elem_nodes: np.ndarray):
    """Native edges/normals/volumes. Returns None if the .so is unavailable."""
    lib = load()
    if lib is None:
        return None
    npoint = coords.shape[0]
    nelem = elem_types.shape[0]
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    et = np.ascontiguousarray(elem_types, dtype=np.int32)
    en = np.full((nelem, 4), -1, dtype=np.int64)
    en[:, :elem_nodes.shape[1]] = elem_nodes
    en = np.ascontiguousarray(en)
    max_edges = nelem * 4
    edges = np.empty((max_edges, 2), dtype=np.int64)
    normals = np.empty((max_edges, 2), dtype=np.float64)
    volume = np.empty(npoint, dtype=np.float64)
    nedge = lib.su2geom_build_dual_2d(
        npoint, _ptr(coords, ctypes.c_double), nelem,
        _ptr(et, ctypes.c_int32), _ptr(en, ctypes.c_int64),
        _ptr(edges, ctypes.c_int64), _ptr(normals, ctypes.c_double),
        _ptr(volume, ctypes.c_double), max_edges)
    if nedge < 0:
        raise RuntimeError("native dual-grid build failed")
    return edges[:nedge].copy(), normals[:nedge].copy(), volume


def adjacency(npoint: int, edges: np.ndarray, maxdeg: int):
    lib = load()
    if lib is None:
        return None
    nedge = edges.shape[0]
    edges = np.ascontiguousarray(edges, dtype=np.int64)
    node_edges = np.empty((npoint, maxdeg), dtype=np.int64)
    node_sign = np.empty((npoint, maxdeg), dtype=np.float64)
    node_nbrs = np.empty((npoint, maxdeg), dtype=np.int64)
    got = lib.su2geom_adjacency(
        npoint, nedge, _ptr(edges, ctypes.c_int64), maxdeg,
        _ptr(node_edges, ctypes.c_int64), _ptr(node_sign, ctypes.c_double),
        _ptr(node_nbrs, ctypes.c_int64))
    if got < 0:
        return None  # degree exceeded; caller retries with bigger maxdeg
    return node_edges, node_sign, node_nbrs
