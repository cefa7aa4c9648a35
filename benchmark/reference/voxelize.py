"""First-come voxelization and the request's host arrays, worked out
again from the raw points.

A point's cell is ``floor((p - range_min) / voxel_size)`` in float32 (a
true division); points outside the grid form no voxel. Voxels are taken
in the order their first point arrives, up to ``max_voxels``, each with
its first ``max_points`` points in arrival order (the published
voxelizer's semantics).
"""

import numpy as np


def voxelize(points, pc_range, voxel_size, max_voxels, max_points):
    """points [N, F] float32 -> (coords [V, 3] int32 zyx, counts [V]
    int32, voxels [V, T, F] float32 zero-padded), the voxels sorted by
    linear id (z, y, x)."""
    pc_range = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    grid = np.round((pc_range[3:] - pc_range[:3]) / vs).astype(np.int64)
    cell = np.floor((points[:, :3] - pc_range[:3]) / vs).astype(np.int64)
    ok = np.all((cell >= 0) & (cell < grid), axis=1)
    pos = np.flatnonzero(ok)
    cell = cell[pos]
    lin = (cell[:, 2] * grid[1] + cell[:, 1]) * grid[0] + cell[:, 0]
    uniq, first, inverse = np.unique(lin, return_index=True,
                                     return_inverse=True)
    # first come, first served
    kept_voxels = np.argsort(first, kind="stable")[:max_voxels]
    kept = np.zeros(len(uniq), bool)
    kept[kept_voxels] = True
    # each point's rank among its voxel's points, in arrival order
    order = np.argsort(inverse, kind="stable")
    inv_s = inverse[order]
    starts = np.flatnonzero(np.r_[True, inv_s[1:] != inv_s[:-1]])
    lengths = np.diff(np.r_[starts, len(order)])
    slot = np.empty(len(order), np.int64)
    slot[order] = np.arange(len(order)) - np.repeat(starts, lengths)
    take = kept[inverse] & (slot < max_points)
    # the kept voxels in linear-id order: uniq is sorted
    row = np.cumsum(kept) - 1
    v = int(kept.sum())
    voxels = np.zeros((v, max_points, points.shape[1]), np.float32)
    voxels[row[inverse[take]], slot[take]] = points[pos[take]]
    counts = np.minimum(np.bincount(inverse, minlength=len(uniq)),
                        max_points)[kept].astype(np.int32)
    ul = uniq[kept]
    coords = np.stack([ul // (grid[0] * grid[1]),
                       (ul // grid[0]) % grid[1], ul % grid[0]],
                      axis=1).astype(np.int32)
    return coords, counts, voxels


def pad_points(points, pc_range, capacity):
    """The points inside ``pc_range`` (min <= xyz < max), in arrival
    order, in a zero-padded [capacity, F] float32 buffer, and their
    count."""
    pc_range = np.asarray(pc_range, np.float32)
    inside = np.all((points[:, :3] >= pc_range[:3])
                    & (points[:, :3] < pc_range[3:]), axis=1)
    points = points[inside]
    count = min(len(points), capacity)
    buf = np.zeros((capacity, points.shape[1]), np.float32)
    buf[:count] = points[:count]
    return buf, count
