"""Flat-point PointPillars inference path (twin of
``second_tpu/models/pp_fast.py``).

The module path materialises a ``[V, T, F]`` buffer (12000 x 100 slots
for ~16k points at xyres_16: 99% padding) and runs the PFN over every
slot. This path keeps the points flat: sort them by pillar once
(:func:`flat_pillarize`), run the PFN as a pointwise [N, C] product,
and reduce each pillar with a segment max (:func:`flat_pfn`).

It equals the module path (``voxelize`` -> the pillar encoder ->
``PointPillarsScatter``) in inference:

  * the decoration (cluster and centre offsets, the variants' quirks)
    comes from per-pillar scatter means;
  * the module path's padded slots join each max with
    ``relu(BN(Linear(0)))``, so pillars of fewer than T points max with
    exactly that per-channel constant here;
  * batch norm uses its running statistics, so it is a per-channel
    affine.

The per-pillar sums go through ``index_add_``, which adds with atomics
on CUDA: the canvas is not bitwise equal run to run there, within ~1e-6
(fp32 sums of up to T points in another order). Everything else is.
"""

import torch

from ..ops.voxelize import sort_by_voxel
from .middle import scatter_canvas
from .voxelnet import predict


def flat_pillarize(points, num_points, voxel_size, range_min, grid_size,
                   max_voxels, max_points_per_voxel):
    """Sort a padded point buffer by pillar id (no [V, T, F] buffer).

    Returns pts_s [N, F] (sorted), coords_pt [N, 3] int32 xyz (the
    point's pillar, -1 for dropped rows), vrank [N] int32 (the point's
    pillar index, ``max_voxels`` for points that feed none: invalid,
    in a pillar past the capacity, or past its pillar's first
    ``max_points_per_voxel``), pillar_coords [V, 3] int32 zyx (-1
    padding), counts [V] int32 (capped at T) and num_voxels.
    """
    pts_s, coords_pt, vrank, _, pillar_coords, counts, num_voxels = (
        sort_by_voxel(points, num_points, voxel_size, range_min, grid_size,
                      max_voxels, max_points_per_voxel))
    return pts_s, coords_pt, vrank, pillar_coords, counts, num_voxels


def _segment(values, index, rows, fill, reduce):
    """``reduce`` ("amax" or "amin") of ``values`` [N, ...] into ``rows``
    rows by ``index`` [N] (int64, ``rows`` = dump), from ``fill``."""
    out = values.new_full((rows + 1,) + values.shape[1:], fill)
    idx = index.view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    return out.scatter_reduce_(0, idx, values, reduce)[:-1]


def flat_pfn(vfe, pts_s, coords_pt, vrank, counts, max_points_per_voxel):
    """The pillar encoder ``vfe`` (a ``voxel_encoders`` PillarFeatureNet,
    in eval mode: its flags, geometry and weights) on the flat sorted
    points -> pooled features [V, C]; zero for empty pillars."""
    v = counts.shape[0]
    t_cap = max_points_per_voxel
    dtype = pts_s.dtype
    nif = vfe.num_input_features

    valid = vrank < v
    vm = valid.to(dtype)[:, None]
    vr = vrank.long()
    vrc = vr.clamp(max=v - 1)
    xyz = pts_s[:, :3]

    # per-pillar xyz mean (cluster offsets)
    sums = xyz.new_zeros(v + 1, 3).index_add_(
        0, vr, torch.where(valid[:, None], xyz, 0.0))[:-1]
    means = sums / counts.clamp(min=1).to(dtype)[:, None]
    f_cluster = (xyz - means[vrc]) * vm

    vx, vy = vfe.voxel_size[0], vfe.voxel_size[1]
    x_off = vx / 2 + vfe.pc_range[0]
    y_off = vy / 2 + vfe.pc_range[1]
    px = coords_pt[:, 0].to(dtype) * vx + x_off
    py = coords_pt[:, 1].to(dtype) * vy + y_off
    f_center = torch.stack([pts_s[:, 0] - px, pts_s[:, 1] - py], -1) * vm

    base = pts_s[:, :nif]
    if vfe.radius:
        r = torch.linalg.norm(pts_s[:, :2], dim=-1, keepdim=True)
        base = torch.cat([r, pts_s[:, 2:nif]], -1)
    elif vfe.center_replaces_xy:
        base = torch.cat([f_center, pts_s[:, 2:nif]], -1)
    feats = [base * vm, f_cluster, f_center]
    # the pillars whose padded slots join the module path's reductions
    part = (counts < t_cap)[:, None]
    if vfe.height:
        z = pts_s[:, 2:3]
        zmax = _segment(torch.where(valid[:, None], z, -1e9), vr, v, -1e9,
                        "amax")
        zmin = _segment(torch.where(valid[:, None], z, 1e9), vr, v, 1e9,
                        "amin")
        # module-path quirk: the padded slots are zero and join the min
        # and max of the pillars that are not full
        zmax = torch.where(part, zmax.clamp(min=0.0), zmax)
        zmin = torch.where(part, zmin.clamp(max=0.0), zmin)
        feats.append((zmax - zmin)[vrc] * vm)
    if vfe.with_distance:
        feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True) * vm)
    x = torch.cat(feats, -1)

    for layer in vfe.pfn_layers:
        lbr = layer.linear_bn_relu
        k, b = lbr.bn.affine()
        y = torch.relu(torch.matmul(x, lbr.linear.weight.t()) * k + b)
        seg = _segment(torch.where(valid[:, None], y, -1e9), vr, v, -1e9,
                       "amax")
        # the module path's padded slots carry relu(BN(Linear(0)))
        seg = torch.where(part, torch.maximum(seg, torch.relu(b)), seg)
        seg = torch.where((counts > 0)[:, None], seg, 0.0)
        if not layer.last_layer:
            x = torch.cat([y, seg[vrc]], -1)
    return seg


def flat_pfn_bev(vfe, pts_s, coords_pt, vrank, pillar_coords, counts,
                 max_points_per_voxel, grid_size):
    """:func:`flat_pfn`, then the pillars on the BEV canvas
    (``PointPillarsScatter``) -> [C, ny, nx]."""
    pooled = flat_pfn(vfe, pts_s, coords_pt, vrank, counts,
                      max_points_per_voxel)
    nx, ny, _ = grid_size
    return scatter_canvas(pooled[None], pillar_coords[None], ny, nx)[0]


@torch.no_grad()
def pointpillars_infer(net, spec, example, *, gen, max_voxels):
    """A batch of points -> (preds, detections) through the flat pillar
    path, the RPN and ``voxelnet.predict``.

    net: a VoxelNet with a PillarFeatureNet encoder (its class carries
    the config's variant flags); example: tensors on the device, the
    padded ``points`` [B, N, F] with ``points_count`` [B, 1], and
    predict's ``anchors`` [B, A, 7] and, where the config masks them,
    ``anchors_mask``; gen: the voxel generator. Frames run one after
    another through the pillar stages, then together through the RPN
    and predict. Unlike the JAX function, which returns the detections
    only, this one returns the preds too.
    """
    vfe = net.voxel_feature_extractor
    grid = tuple(int(x) for x in gen.grid_size)
    vs = tuple(float(x) for x in gen.voxel_size)
    rmin = tuple(float(x) for x in gen.point_cloud_range[:3])
    t = int(gen.max_num_points_per_voxel)
    bev = torch.stack([
        flat_pfn_bev(vfe, *flat_pillarize(p, n, vs, rmin, grid, max_voxels,
                                          t)[:5],
                     max_points_per_voxel=t, grid_size=grid)
        for p, n in zip(example["points"], example["points_count"][:, 0])])
    preds = net.rpn_preds(bev)
    return preds, predict(spec, preds, example)
