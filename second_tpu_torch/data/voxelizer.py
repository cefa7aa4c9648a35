"""Host-side point-cloud voxelizer (the port's copy of
``second_tpu/data/voxelizer.py``).

Replaces the reference's external C++ ``spconv.utils.VoxelGeneratorV2``
(called from second/builder/voxel_builder.py:23-32 and
second/data/preprocess.py:302-315).  Semantics:

  * first-come-first-serve: voxels are emitted in order of each voxel's
    first point; within a voxel, points keep their incoming order and
    overflow beyond ``max_num_points`` is dropped;
  * voxels beyond ``max_voxels`` are dropped entirely;
  * ``coordinates`` are int32 zyx;
  * ``full_mean``: empty slots of partially-filled voxels are filled
    with the voxel's point mean;
  * ``block_filtering``: ground shedding — voxels within
    ``height_threshold`` of the lowest point in their BEV block
    (block width = block_factor * block_size voxels) are removed;
  * ``generate_multi_gpu`` (the fixed-shape variant the reference uses
    for DataParallel and that we use universally for TPU static
    shapes): arrays padded to exactly ``max_voxels``.

The default mode runs the C++ FCFS kernel (``native/``; a failed build
raises); ``full_mean`` and ``block_filtering`` run vectorized numpy
(sort-based grouping).
"""

import numpy as np


class VoxelGenerator:
    def __init__(self,
                 voxel_size,
                 point_cloud_range,
                 max_num_points,
                 max_voxels=20000,
                 full_mean=False,
                 block_filtering=False,
                 block_factor=8,
                 block_size=3,
                 height_threshold=0.1):
        point_cloud_range = np.array(point_cloud_range, dtype=np.float32)
        voxel_size = np.array(voxel_size, dtype=np.float32)
        grid_size = (point_cloud_range[3:] - point_cloud_range[:3]) / voxel_size
        grid_size = np.round(grid_size).astype(np.int64)  # xyz
        self._voxel_size = voxel_size
        self._point_cloud_range = point_cloud_range
        self._max_num_points = max_num_points
        self._max_voxels = max_voxels
        self._grid_size = grid_size
        self._full_mean = full_mean
        self._block_filtering = block_filtering
        self._block_factor = block_factor
        self._block_size = block_size
        self._height_threshold = height_threshold
        # the native kernel's dense index grids, made when first needed:
        # a call takes one for itself (the loader's threads voxelize
        # with one generator while ctypes releases the GIL), so there
        # are as many as calls that ran at once. list.pop and append
        # are atomic, so no lock is held, in this process or a fork.
        self._workspaces = []

    @property
    def voxel_size(self):
        return self._voxel_size

    @property
    def point_cloud_range(self):
        return self._point_cloud_range

    @property
    def max_num_points_per_voxel(self):
        return self._max_num_points

    @property
    def grid_size(self):
        return self._grid_size

    def generate(self, points, max_voxels=None):
        """Dynamic-count voxelization (reference .generate parity)."""
        res = self._voxelize(points, max_voxels or self._max_voxels)
        voxels, coors, num_points, num_voxels = res
        return {
            "voxels": voxels[:num_voxels],
            "coordinates": coors[:num_voxels],
            "num_points_per_voxel": num_points[:num_voxels],
        }

    def generate_multi_gpu(self, points, max_voxels=None):
        """Fixed-shape voxelization: arrays padded to max_voxels."""
        res = self._voxelize(points, max_voxels or self._max_voxels)
        voxels, coors, num_points, num_voxels = res
        return {
            "voxels": voxels,
            "coordinates": coors,
            "num_points_per_voxel": num_points,
            "voxel_num": num_voxels,
        }

    # ------------------------------------------------------------------
    def _voxelize(self, points, max_voxels):
        if self._full_mean or self._block_filtering:
            return self._voxelize_numpy(points, max_voxels)
        return self._native_voxelize(points, max_voxels)

    def _native_voxelize(self, points, max_voxels):
        """C++ FCFS kernel (the modes above have no native version)."""
        from ..native import voxelize_native

        try:
            workspace = self._workspaces.pop()
        except IndexError:
            workspace = np.full(int(np.prod(self._grid_size)), -1, np.int32)
        try:
            return voxelize_native.points_to_voxel(
                points, self._voxel_size, self._point_cloud_range,
                self._max_num_points, max_voxels,
                tuple(int(v) for v in self._grid_size), workspace)
        finally:
            self._workspaces.append(workspace)

    def _voxelize_numpy(self, points, max_voxels):
        T = self._max_num_points
        nfeat = points.shape[1]
        vmin = self._point_cloud_range[:3]
        nx, ny, nz = (int(v) for v in self._grid_size)

        coords = np.floor(
            (points[:, :3] - vmin) / self._voxel_size
        ).astype(np.int64)  # xyz
        in_bounds = np.all((coords >= 0) & (coords < self._grid_size), axis=1)
        pts = points[in_bounds]
        c = coords[in_bounds]
        lin = c[:, 0] + c[:, 1] * nx + c[:, 2] * (nx * ny)

        # first-occurrence-ordered unique voxel ids
        uniq, first_idx, inverse = np.unique(
            lin, return_index=True, return_inverse=True
        )
        # rank voxels by first point occurrence (FCFS voxel order)
        order_of_uniq = np.argsort(first_idx, kind="stable")
        rank_of_uniq = np.empty_like(order_of_uniq)
        rank_of_uniq[order_of_uniq] = np.arange(len(uniq))
        vrank = rank_of_uniq[inverse]  # [P] voxel rank per point

        # slot within voxel, in incoming point order
        sort_key = np.argsort(vrank, kind="stable")
        sorted_vrank = vrank[sort_key]
        group_start = np.zeros(len(sorted_vrank), dtype=np.int64)
        if len(sorted_vrank) > 0:
            new_group = np.concatenate(
                [[True], sorted_vrank[1:] != sorted_vrank[:-1]]
            )
            starts = np.where(new_group)[0]
            group_start = starts[np.cumsum(new_group) - 1]
        slot_sorted = np.arange(len(sorted_vrank)) - group_start
        slot = np.empty_like(slot_sorted)
        slot[sort_key] = slot_sorted

        num_real_voxels = len(uniq)

        if self._block_filtering and num_real_voxels > 0:
            keep_voxel = self._block_filter_mask(pts, c, uniq, vrank)
            # re-rank surviving voxels, preserving FCFS order
            new_rank = np.full(num_real_voxels, -1, dtype=np.int64)
            kept = np.where(keep_voxel)[0]
            new_rank[kept] = np.arange(len(kept))
            vrank = new_rank[vrank]
            keep_pts = vrank >= 0
            pts, c, vrank, slot = (
                pts[keep_pts], c[keep_pts], vrank[keep_pts], slot[keep_pts])
            num_real_voxels = len(kept)
        num_voxels = min(num_real_voxels, max_voxels)

        keep = (vrank < max_voxels) & (slot < T)
        pts, c, vrank, slot = pts[keep], c[keep], vrank[keep], slot[keep]

        voxels = np.zeros((max_voxels, T, nfeat), dtype=points.dtype)
        coors = np.zeros((max_voxels, 3), dtype=np.int32)
        num_points = np.zeros((max_voxels,), dtype=np.int32)
        voxels[vrank, slot] = pts
        coors[vrank] = c[:, ::-1]  # zyx
        np.add.at(num_points, vrank, 1)

        if self._full_mean and num_voxels > 0:
            npts = np.maximum(num_points[:, None, None], 1)
            means = voxels.sum(axis=1, keepdims=True) / npts
            slot_ids = np.arange(T).reshape(1, T, 1)
            filled = slot_ids < num_points[:, None, None]
            voxels = np.where(filled, voxels, means)
            voxels[num_voxels:] = 0

        return voxels, coors, num_points, num_voxels

    def _block_filter_mask(self, pts, c, uniq, vrank):
        """Ground shedding: drop voxels whose lowest point is within
        height_threshold of the lowest point in their BEV block."""
        nx = int(self._grid_size[0])
        block_w = self._block_factor * self._block_size
        nbx = -(-nx // block_w)
        num_voxels = len(uniq)
        # per-voxel min z (over that voxel's points)
        vz = np.full(num_voxels, np.inf, dtype=np.float64)
        np.minimum.at(vz, vrank, pts[:, 2])
        # per-voxel block id from its xy coords
        vx = np.zeros(num_voxels, dtype=np.int64)
        vy = np.zeros(num_voxels, dtype=np.int64)
        vx[vrank] = c[:, 0]
        vy[vrank] = c[:, 1]
        ny = int(self._grid_size[1])
        nby = -(-ny // block_w)
        block_id = (vx // block_w) + (vy // block_w) * nbx
        block_min = np.full(nbx * nby, np.inf)
        np.minimum.at(block_min, block_id, vz)
        ground = block_min[block_id]
        return (vz - ground) >= self._height_threshold
