"""ctypes bindings for the C++ native runtime (native/tpurt_native.cpp).

Covers the host-side work where native code pays off — OBJ parsing and the
CPU golden-oracle BVH build — mirroring the reference's native layer
(tiny_obj_loader + Source/BVHBuilder.cpp [RECALL]). The device path stays
JAX; every entry point here has a pure-Python fallback, so the library is
optional (built on demand with g++ via native/Makefile).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libhost_native.so")
_lib = None
_lib_failed = False


def _try_build() -> bool:
    """Run the library's make target (a no-op when it is up to date, so a
    source edit never leaves a stale library loaded). Failures are printed:
    callers fall back visibly, never silently."""
    try:
        proc = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                              text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"tpurt: cannot build {_LIB_PATH}: {e}", file=sys.stderr)
        return False
    if proc.returncode != 0:
        print(f"tpurt: building {_LIB_PATH} failed:\n{proc.stderr}",
              file=sys.stderr)
        return False
    return os.path.exists(_LIB_PATH)


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building or rebuilding if needed) the native library; None if
    unavailable."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    if not _try_build():
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        print(f"tpurt: cannot load {_LIB_PATH}: {e}", file=sys.stderr)
        _lib_failed = True
        return None
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_int_p = ctypes.POINTER(ctypes.c_int32)
    lib.obj_load.restype = ctypes.c_void_p
    lib.obj_load.argtypes = [ctypes.c_char_p]
    for name in ("obj_num_positions", "obj_num_normals",
                 "obj_num_texcoords", "obj_num_tris"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.obj_copy_positions.argtypes = [ctypes.c_void_p, c_float_p]
    lib.obj_copy_normals.argtypes = [ctypes.c_void_p, c_float_p]
    lib.obj_copy_texcoords.argtypes = [ctypes.c_void_p, c_float_p]
    lib.obj_copy_tris.argtypes = [ctypes.c_void_p, c_int_p, c_int_p]
    lib.obj_copy_tri_tex.argtypes = [ctypes.c_void_p, c_int_p]
    lib.obj_copy_tri_mtl.argtypes = [ctypes.c_void_p, c_int_p]
    for name in ("obj_mtl_names_len", "obj_mtllibs_len"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.obj_copy_mtl_names.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.obj_copy_mtllibs.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.obj_free.argtypes = [ctypes.c_void_p]
    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [c_float_p, ctypes.c_int64, c_int_p,
                              ctypes.c_int64, ctypes.c_int32]
    lib.bvh_build_sbvh.restype = ctypes.c_void_p
    lib.bvh_build_sbvh.argtypes = [c_float_p, ctypes.c_int64, c_int_p,
                                   ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_float, ctypes.c_float]
    lib.bvh_num_nodes.restype = ctypes.c_int64
    lib.bvh_num_nodes.argtypes = [ctypes.c_void_p]
    lib.bvh_num_refs.restype = ctypes.c_int64
    lib.bvh_num_refs.argtypes = [ctypes.c_void_p]
    lib.bvh_copy.argtypes = [ctypes.c_void_p, c_float_p, c_float_p, c_int_p,
                             c_int_p, c_int_p, c_int_p]
    lib.bvh_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def ensure_native() -> bool:
    """Build+load the native library eagerly (no-op when already loaded).
    Callers that time the first native call (bench.py) use this to keep
    the one-time g++ compile out of their measured sections."""
    return available()


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_raw(path: str) -> Optional[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray,
                                              np.ndarray, list, list]]:
    """Fast OBJ parse -> (positions f32[P,3], normals f32[N,3],
    texcoords f32[TC,2], tri_pos i32[T,3], tri_nrm i32[T,3] with -1 for
    'no normal', tri_tex i32[T,3] (-1 = none), tri_mtl i32[T] material
    index (-1 = none), mtl_names, mtllib_names). None if the native
    library is unavailable or the file has no faces."""
    lib = load_library()
    if lib is None:
        return None
    h = lib.obj_load(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        np_, nn, ntc, nt = (lib.obj_num_positions(h),
                            lib.obj_num_normals(h),
                            lib.obj_num_texcoords(h), lib.obj_num_tris(h))
        if nt == 0:
            raise ValueError(f"no faces found in OBJ file: {path}")
        pos = np.empty((np_, 3), np.float32)
        nrm = np.empty((max(nn, 1), 3), np.float32)
        tc = np.empty((max(ntc, 1), 2), np.float32)
        tp = np.empty((nt, 3), np.int32)
        tn = np.empty((nt, 3), np.int32)
        tt = np.empty((nt, 3), np.int32)
        tm = np.empty(nt, np.int32)
        if np_:
            lib.obj_copy_positions(h, _fp(pos))
        if nn:
            lib.obj_copy_normals(h, _fp(nrm))
        if ntc:
            lib.obj_copy_texcoords(h, _fp(tc))
        lib.obj_copy_tris(h, _ip(tp), _ip(tn))
        lib.obj_copy_tri_tex(h, _ip(tt))
        lib.obj_copy_tri_mtl(h, _ip(tm))

        def _names(len_fn, copy_fn):
            n = len_fn(h)
            if n == 0:
                return []
            buf = ctypes.create_string_buffer(int(n))
            copy_fn(h, buf)
            return buf.raw[:n].decode(errors="replace").split("\n")

        mtl_names = _names(lib.obj_mtl_names_len, lib.obj_copy_mtl_names)
        mtllibs = _names(lib.obj_mtllibs_len, lib.obj_copy_mtllibs)
        return pos, nrm[:nn], tc[:ntc], tp, tn, tt, tm, mtl_names, mtllibs
    finally:
        lib.obj_free(h)


def build_sah_bvh(vertices: np.ndarray, indices: np.ndarray,
                  leaf_size: int = 4, spatial_alpha: float | None = None,
                  spatial_budget: float = 1.3):
    """Native binned-SAH build -> CpuBVH (same layout as the NumPy oracle's
    recursive builder); None if the library is unavailable.

    spatial_alpha: when set (< 1), enables SBVH spatial splits — a node
    whose best object split's child overlap exceeds ``alpha * root_area``
    also evaluates chopped-binning spatial splits that duplicate straddling
    triangle references with clipped boxes (capped at ``spatial_budget *
    num_tris`` references). tri_order then contains duplicate triangle ids;
    every id still maps to an original triangle for shading."""
    lib = load_library()
    if lib is None:
        return None
    from .bvh.reference import CpuBVH
    v = np.ascontiguousarray(vertices, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    if spatial_alpha is not None:
        h = lib.bvh_build_sbvh(_fp(v), v.shape[0], _ip(idx), idx.shape[0],
                               leaf_size, ctypes.c_float(spatial_alpha),
                               ctypes.c_float(spatial_budget))
    else:
        h = lib.bvh_build(_fp(v), v.shape[0], _ip(idx), idx.shape[0],
                          leaf_size)
    try:
        n = lib.bvh_num_nodes(h)
        nrefs = lib.bvh_num_refs(h)
        bb_min = np.empty((n, 3), np.float32)
        bb_max = np.empty((n, 3), np.float32)
        prim_start = np.empty(n, np.int32)
        prim_count = np.empty(n, np.int32)
        skip = np.empty(n, np.int32)
        order = np.empty(nrefs, np.int32)
        lib.bvh_copy(h, _fp(bb_min), _fp(bb_max), _ip(prim_start),
                     _ip(prim_count), _ip(skip), _ip(order))
        return CpuBVH(bb_min=bb_min, bb_max=bb_max, prim_start=prim_start,
                      prim_count=prim_count, skip=skip, tri_order=order)
    finally:
        lib.bvh_free(h)
