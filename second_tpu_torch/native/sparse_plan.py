"""ctypes bindings for host-side sparse-conv planning.

The reference's spconv builds its rulebooks on CPU inside every conv
call (external spconv ops used by second/pytorch/models/middle.py); we
do the same once per example in the data pipeline, so the device
program is gather-GEMMs with no device-side hash/sort work.
"""

import ctypes

import numpy as np

from .build import load_lib

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_lib()
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.subm_plan.argtypes = [
            i32p, i64, i64, i64, i64, i32p, i64, i32p]
        lib.down_plan.argtypes = [
            i32p, i64, i64, i64, i64,
            i64, i64, i64, i64, i64, i64, i64, i64, i64,
            i32p, i64, i64, i32p, i32p]
        lib.down_plan.restype = i64
        _lib = lib
    return _lib


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def subm_plan(coords, shape, offsets):
    """coords [V, 3] int32 zyx sorted by lin (-1 pads); offsets [K, 3]
    centered. Returns slots [V, K] int32 (miss -> V)."""
    lib = _load()
    coords = np.ascontiguousarray(coords, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int32)
    v = coords.shape[0]
    k = offsets.shape[0]
    slots = np.empty((v, k), np.int32)
    lib.subm_plan(
        _ip(coords), v, int(shape[0]), int(shape[1]), int(shape[2]),
        _ip(offsets), k, _ip(slots))
    return slots


def down_plan(coords, shape, kernel, stride, padding, offsets, out_cap):
    """Strided-conv plan. Returns (out_coords [out_cap, 3],
    conv_slots [out_cap, K], total_active_before_truncation)."""
    lib = _load()
    coords = np.ascontiguousarray(coords, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int32)
    v = coords.shape[0]
    k = offsets.shape[0]
    out_coords = np.empty((out_cap, 3), np.int32)
    conv_slots = np.empty((out_cap, k), np.int32)
    total = lib.down_plan(
        _ip(coords), v, int(shape[0]), int(shape[1]), int(shape[2]),
        int(kernel[0]), int(kernel[1]), int(kernel[2]),
        int(stride[0]), int(stride[1]), int(stride[2]),
        int(padding[0]), int(padding[1]), int(padding[2]),
        _ip(offsets), k, int(out_cap), _ip(out_coords), _ip(conv_slots))
    return out_coords, conv_slots, int(total)
