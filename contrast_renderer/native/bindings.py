"""ctypes bindings for the native geometry kernels (geometry.cpp).

The shared library is compiled on first use into the package directory
(g++ -O3); callers must check :func:`available` or rely on modules that
fall back to the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "geometry.cpp")
_LIB_PATH = os.path.join(_HERE, "_geometry.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _cache_lib_path():
    # Site-packages may be read-only (system installs); a per-user
    # cache directory is the fallback build target.
    return os.path.join(
        os.environ.get(
            "XDG_CACHE_HOME",
            os.path.join(os.path.expanduser("~"), ".cache"),
        ),
        "contrast_renderer",
        "_geometry.so",
    )


def _build():
    global _LIB_PATH
    targets = [_LIB_PATH, _cache_lib_path()]
    last_error = None
    for target in targets:
        try:
            os.makedirs(os.path.dirname(target), exist_ok=True)
            subprocess.run(
                [
                    "g++",
                    "-O3",
                    "-march=native",
                    "-shared",
                    "-fPIC",
                    "-o",
                    target,
                    _SRC,
                ],
                check=True,
                capture_output=True,
            )
            _LIB_PATH = target
            return
        except (OSError, subprocess.CalledProcessError) as error:
            last_error = error
    raise last_error


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            global _LIB_PATH
            for candidate in (_LIB_PATH, _cache_lib_path()):
                if os.path.exists(candidate) and os.path.getmtime(
                    candidate
                ) >= os.path.getmtime(_SRC):
                    _LIB_PATH = candidate
                    break
            else:
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
        except Exception:
            _build_failed = True
            return None
        c_double_p = ctypes.POINTER(ctypes.c_double)
        c_float_p = ctypes.POINTER(ctypes.c_float)
        c_i64_p = ctypes.POINTER(ctypes.c_int64)
        c_u8_p = ctypes.POINTER(ctypes.c_uint8)
        lib.eval_rational_quadratic.argtypes = [
            c_double_p, ctypes.c_int64, c_double_p, ctypes.c_int64, c_double_p,
        ]
        lib.eval_rational_cubic.argtypes = [
            c_double_p, ctypes.c_int64, c_double_p, ctypes.c_int64, c_double_p,
        ]
        lib.polyline_arc_length.argtypes = [c_double_p, ctypes.c_int64, c_double_p]
        lib.tessellate_quadratic_paths.argtypes = [
            c_i64_p, ctypes.c_int64, c_double_p, c_u8_p, c_double_p,
            c_float_p, c_i64_p, c_float_p, c_float_p, c_i64_p,
            c_double_p, c_i64_p,
        ]
        lib.convex_hull.argtypes = [
            c_double_p, ctypes.c_int64, ctypes.c_double, c_double_p,
        ]
        lib.convex_hull.restype = ctypes.c_int64
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(array, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def eval_rational_quadratic(power_basis, ts):
    """(n, 3, 3) power bases × (m,) parameters → (n, m, 2) points."""
    lib = _load()
    pb = np.ascontiguousarray(power_basis, np.float64).reshape(-1, 3, 3)
    ts = np.ascontiguousarray(ts, np.float64)
    out = np.empty((len(pb), len(ts), 2), np.float64)
    lib.eval_rational_quadratic(
        _ptr(pb, ctypes.c_double), len(pb), _ptr(ts, ctypes.c_double),
        len(ts), _ptr(out, ctypes.c_double),
    )
    return out


def eval_rational_cubic(power_basis, ts):
    """(n, 4, 3) power bases × (m,) parameters → (n, m, 2) points."""
    lib = _load()
    pb = np.ascontiguousarray(power_basis, np.float64).reshape(-1, 4, 3)
    ts = np.ascontiguousarray(ts, np.float64)
    out = np.empty((len(pb), len(ts), 2), np.float64)
    lib.eval_rational_cubic(
        _ptr(pb, ctypes.c_double), len(pb), _ptr(ts, ctypes.c_double),
        len(ts), _ptr(out, ctypes.c_double),
    )
    return out


def polyline_arc_length(points):
    """(n, 2) polyline → (n,) cumulative arc length."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float64)
    out = np.empty(len(pts), np.float64)
    lib.polyline_arc_length(
        _ptr(pts, ctypes.c_double), len(pts), _ptr(out, ctypes.c_double)
    )
    return out


def tessellate_quadratic_paths(path_offsets, starts, seg_kind, seg_points):
    """Batch-tessellate glyph-style paths (lines + integral quadratics).

    Returns (solid_xy (Ns,3,2) f32, curve_xy (Nc,3,2) f32,
    curve_aux (Nc,3,3) f32, hull_points (Nh,2) f64).
    """
    lib = _load()
    path_offsets = np.ascontiguousarray(path_offsets, np.int64)
    starts = np.ascontiguousarray(starts, np.float64)
    seg_kind = np.ascontiguousarray(seg_kind, np.uint8)
    seg_points = np.ascontiguousarray(seg_points, np.float64)
    num_paths = len(path_offsets) - 1
    num_segs = len(seg_kind)
    max_curve = int((seg_kind == 1).sum())
    # Fan points per path = 1 + lines + quads; triangles = points - 2.
    max_solid = num_segs + max_curve + num_paths
    max_hull = num_segs + max_curve + num_paths
    solid_xy = np.empty((max(max_solid, 1), 3, 2), np.float32)
    curve_xy = np.empty((max(max_curve, 1), 3, 2), np.float32)
    curve_aux = np.empty((max(max_curve, 1), 3, 3), np.float32)
    hull_points = np.empty((max(max_hull, 1), 2), np.float64)
    solid_count = np.zeros(1, np.int64)
    curve_count = np.zeros(1, np.int64)
    hull_count = np.zeros(1, np.int64)
    lib.tessellate_quadratic_paths(
        _ptr(path_offsets, ctypes.c_int64), num_paths,
        _ptr(starts, ctypes.c_double),
        _ptr(seg_kind, ctypes.c_uint8), _ptr(seg_points, ctypes.c_double),
        _ptr(solid_xy, ctypes.c_float), _ptr(solid_count, ctypes.c_int64),
        _ptr(curve_xy, ctypes.c_float), _ptr(curve_aux, ctypes.c_float),
        _ptr(curve_count, ctypes.c_int64),
        _ptr(hull_points, ctypes.c_double), _ptr(hull_count, ctypes.c_int64),
    )
    return (
        solid_xy[: solid_count[0]],
        curve_xy[: curve_count[0]],
        curve_aux[: curve_count[0]],
        hull_points[: hull_count[0]],
    )


def convex_hull(points, margin=1e-4):
    """(n, 2) points → (m, 2) CCW hull (native Andrew's chain)."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float64)
    out = np.empty_like(pts)
    m = lib.convex_hull(
        _ptr(pts, ctypes.c_double), len(pts), margin, _ptr(out, ctypes.c_double)
    )
    return out[:m].copy()
