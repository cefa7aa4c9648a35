"""ctypes bindings for host-side hot kernels (iou matrix, per-object
noise search) — the loops the reference JIT-compiled with numba."""

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
