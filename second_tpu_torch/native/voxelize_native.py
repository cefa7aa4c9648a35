"""ctypes binding for the native FCFS voxelizer."""

import ctypes

import numpy as np

from .build import load_lib

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_lib()
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.points_to_voxel.restype = ctypes.c_int64
        lib.points_to_voxel.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, f32p, f32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, f32p, i32p, i32p, i32p,
        ]
        _lib = lib
    return _lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def points_to_voxel(points, voxel_size, coors_range, max_points, max_voxels,
                    grid_size, workspace):
    """FCFS voxelization via the native kernel.

    points: [N, F] float32 contiguous; grid_size: (nx, ny, nz);
    workspace: int32 [nz*ny*nx] filled with -1 (restored by the kernel).
    Returns (voxels, coors, num_points_per_voxel, voxel_num).
    """
    lib = _load()
    points = np.ascontiguousarray(points, np.float32)
    vs = np.ascontiguousarray(voxel_size, np.float32)
    cr = np.ascontiguousarray(coors_range, np.float32)
    nfeat = points.shape[1]
    nx, ny, nz = (int(v) for v in grid_size)
    voxels = np.zeros((max_voxels, max_points, nfeat), np.float32)
    coors = np.zeros((max_voxels, 3), np.int32)
    counts = np.zeros((max_voxels,), np.int32)
    n = lib.points_to_voxel(
        _fp(points), points.shape[0], nfeat, _fp(vs), _fp(cr),
        max_points, max_voxels, nx, ny, nz,
        _fp(voxels), _ip(coors), _ip(counts), _ip(workspace))
    return voxels, coors, counts, int(n)
