"""On-device static-shape voxelization (twin of ``second_tpu/ops/voxelize.py``).

A padded point buffer becomes padded ``[max_voxels, T, F]`` voxels, zyx
coords and counts without a host round trip or a host sync: points are
stable-sorted by linear voxel id, so each voxel's points stay in their
incoming order. The voxel SET, each voxel's points and their order match
the host voxelizer (reference ``VoxelGeneratorV2``), including at an
overflow of ``max_voxels``: the voxels whose first point arrives first
are kept (first come, first served), as are the first T points of a
voxel. Voxels come out in linear-id order, not first-arrival order;
downstream consumers scatter by coordinate and do not care.

``sort_by_voxel`` is the shared first half; ``models.pp_fast``'s flat
pillar path uses it without building the ``[V, T, F]`` buffer.
"""

import torch


def sort_by_voxel(points, num_points, voxel_size, range_min, grid_size,
                  max_voxels, max_points_per_voxel):
    """Sort a padded point buffer by voxel.

    Args:
        points: [N, F] float (xyz first); rows >= ``num_points`` are
            padding.
        num_points: int or 0-dim int tensor, the valid rows.
        voxel_size, range_min: xyz floats; grid_size: (nx, ny, nz).
        max_voxels: capacity V; max_points_per_voxel: T.

    Returns pts_s [N, F] (sorted), coords_s [N, 3] int32 xyz (-1 for
    dropped rows), vr [N] int32 (the point's voxel, V for points not
    written: invalid, in a voxel past the capacity or past its T-th
    slot), slot [N] int64 (its rank in its voxel), coords [V, 3] int32
    zyx (-1 padding), counts [V] int32 (capped at T) and num_voxels
    (0-dim int32).
    """
    n = points.shape[0]
    nx, ny, nz = grid_size
    t = max_points_per_voxel
    dev = points.device
    # floor((p - rmin) / vs) in float32, a true division as the host
    # voxelizer computes it, so a point on a cell boundary lands in the
    # same cell. The divisor is a device tensor: CUDA divides by a CPU
    # scalar as a product by its reciprocal, which moves such points
    # (so does XLA by a constant, see ROADMAP). torch.full writes it on
    # the device; no host data is copied.
    coords = torch.stack([
        torch.floor((points[:, i] - range_min[i]) / torch.full(
            (), voxel_size[i], dtype=points.dtype, device=dev))
        for i in range(3)], 1).long()
    idx = torch.arange(n, device=dev)
    valid = ((idx < num_points) & (coords >= 0).all(1) & (coords[:, 0] < nx)
             & (coords[:, 1] < ny) & (coords[:, 2] < nz))
    lin = coords[:, 0] + coords[:, 1] * nx + coords[:, 2] * (nx * ny)
    sentinel = nx * ny * nz  # invalid points sort last
    lin = torch.where(valid, lin, sentinel)

    # a stable sort keeps each voxel's points in their incoming order
    lin_s, order = torch.sort(lin, stable=True)
    pts_s = points[order]
    valid_s = lin_s < sentinel
    coords_s = torch.where(valid_s[:, None], coords[order], -1)

    new_group = torch.cat([valid_s.new_ones(1), lin_s[1:] != lin_s[:-1]])
    new_group &= valid_s
    # group starts increase, so a running max gives each point its own
    group_start = torch.cummax(torch.where(new_group, idx, 0), 0).values
    slot = idx - group_start

    # first come, first served on overflow: keep the voxels whose first
    # point arrives earliest in the incoming order, as the host
    # voxelizer does (the lowest linear ids would drop a contiguous
    # region)
    first_fi = order[group_start]
    start_fi = torch.where(new_group, order, n)
    if max_voxels < n:
        kth = torch.sort(start_fi).values[max_voxels - 1]
    else:
        kth = n
    keep_pt = valid_s & (first_fi <= kth)
    new_voxel = new_group & (start_fi <= kth)
    vrank = torch.cumsum(new_voxel, 0) - 1
    num_voxels = new_voxel.sum()
    write_ok = keep_pt & (vrank < max_voxels) & (slot < t)
    vr = torch.where(write_ok, vrank, max_voxels)

    # coords and counts have one writer per voxel, its first point; the
    # others write the dump row V, which is cut off. A voxel's length
    # runs to the next group start (a reverse running min over the
    # starts), and the last valid group stops at the padding.
    start_ok = new_voxel & (vrank < max_voxels)
    vr1 = torch.where(start_ok, vrank, max_voxels)
    out_coords = coords.new_full((max_voxels + 1, 3), -1)
    out_coords[vr1] = torch.where(start_ok[:, None], coords_s.flip(1), -1)
    starts = torch.where(new_group, idx, n)
    next_start = torch.cat([
        starts.flip(0).cummin(0).values.flip(0)[1:], starts.new_full((1,), n)])
    n_valid = valid_s.sum()
    group_len = (torch.minimum(next_start, n_valid) - idx).clamp(max=t)
    counts = idx.new_zeros(max_voxels + 1)
    counts[vr1] = torch.where(start_ok, group_len, 0)
    return (pts_s, coords_s.int(), vr.int(), slot, out_coords[:-1].int(),
            counts[:-1].int(), num_voxels.clamp(max=max_voxels).int())


def voxelize(points, num_points, voxel_size, range_min, grid_size,
             max_voxels, max_points_per_voxel, full_mean=False):
    """Voxelize a padded point buffer (arguments as :func:`sort_by_voxel`).

    Returns voxels [V, T, F] (zero padding), coords [V, 3] int32 zyx (-1
    padding), num_per_voxel [V] int32 and num_voxels (0-dim int32).
    full_mean: the empty slots of each voxel hold the mean of its points
    (the generator's ``full_empty_part_with_mean``); empty voxels stay
    zero.
    """
    pts_s, _, vr, slot, coords, counts, num_voxels = sort_by_voxel(
        points, num_points, voxel_size, range_min, grid_size, max_voxels,
        max_points_per_voxel)
    ok = vr < max_voxels
    voxels = points.new_zeros(
        (max_voxels + 1, max_points_per_voxel, points.shape[1]))
    # the rows not written all go to (V, 0), with zeros
    voxels[vr.long(), torch.where(ok, slot, 0)] = torch.where(
        ok[:, None], pts_s, 0.0)
    voxels = voxels[:-1]
    if full_mean:
        n = counts[:, None, None]
        means = voxels.sum(1, keepdim=True) / n.clamp(min=1).to(voxels.dtype)
        filled = torch.arange(max_points_per_voxel,
                              device=points.device)[None, :, None] < n
        voxels = torch.where(filled | (n == 0), voxels, means)
    return voxels, coords, counts, num_voxels
