"""ctypes bindings for host-side hot kernels (iou matrix, per-object
noise search — the loops the reference JIT-compiled with numba — and the
flat pillar path's range filter and padding)."""

import ctypes

import numpy as np

from .build import load_lib

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_lib()
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.iou_matrix.argtypes = [
            dp, ctypes.c_int64, dp, ctypes.c_int64, ctypes.c_double, dp]
        lib.noise_per_box.argtypes = [
            dp, ctypes.c_int64, ctypes.c_int64, u8p, dp, dp, ip]
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.pad_points.restype = i64
        lib.pad_points.argtypes = [
            vp, i64, i64, i32, dp, i32, vp, i32, i64]
        _lib = lib
    return _lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def iou_matrix(boxes, query_boxes, eps=1.0):
    lib = _load()
    boxes = np.ascontiguousarray(boxes, np.float64)
    query_boxes = np.ascontiguousarray(query_boxes, np.float64)
    out = np.zeros((boxes.shape[0], query_boxes.shape[0]), np.float64)
    lib.iou_matrix(
        _dp(boxes), boxes.shape[0], _dp(query_boxes), query_boxes.shape[0],
        float(eps), _dp(out))
    return out


def noise_per_box(boxes_bv, valid_mask, loc_noises, rot_noises):
    lib = _load()
    boxes_bv = np.ascontiguousarray(boxes_bv, np.float64)
    valid = np.ascontiguousarray(valid_mask, np.uint8)
    loc = np.ascontiguousarray(loc_noises, np.float64)
    rot = np.ascontiguousarray(rot_noises, np.float64)
    n, m = rot.shape
    success = np.zeros(n, np.int64)
    lib.noise_per_box(
        _dp(boxes_bv), n, m,
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _dp(loc), _dp(rot),
        success.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return success


_FLOATS = (np.dtype(np.float32), np.dtype(np.float64))


def pad_points(points, pc_range, capacity, dtype):
    """The native pass behind ``data.preprocess.pad_points``: the rows of
    ``points`` [N, F >= 3] (float32 or float64) with ``pc_range[:3] <=
    xyz < pc_range[3:]``, compared in the dtype NumPy promotes the two to,
    in order in a [capacity, F] ``dtype`` (float32 or float64) buffer
    whose other rows are zero. Returns the buffer and the in-range count,
    which may pass ``capacity``."""
    lib = _load()
    points = np.ascontiguousarray(points)
    rng = np.asarray(pc_range)
    out_dtype = np.dtype(dtype)
    if points.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise TypeError(f"pad_points takes float32 or float64 points and "
                        f"buffers, not {points.dtype} -> {out_dtype}")
    if points.ndim != 2 or points.shape[1] < 3 or rng.shape != (6,):
        raise ValueError(f"pad_points takes points [N, F >= 3] and a range "
                         f"of 6, not {points.shape} and {rng.shape}")
    compare_f64 = np.result_type(points.dtype, rng.dtype) == np.float64
    bounds = np.ascontiguousarray(rng, np.float64)
    buf = np.empty((capacity, points.shape[1]), out_dtype)
    total = lib.pad_points(
        points.ctypes.data, points.shape[0], points.shape[1],
        int(points.dtype == np.float64), _dp(bounds), int(compare_f64),
        buf.ctypes.data, int(out_dtype == np.float64), capacity)
    return buf, int(total)
