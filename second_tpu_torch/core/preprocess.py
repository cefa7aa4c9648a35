"""Point-cloud augmentation primitives (host, numpy).

Port of second/core/preprocess.py without numba: the per-object noise
search (noise_per_object_v3_, reference :582-680) precomputes all
candidate corner sets vectorized and keeps only the sequential
accept/reject over boxes; collision testing uses the vectorized
rotated-rectangle intersection from core.rotated_iou instead of the
reference's segment-intersection numba kernel (same accept decisions —
boxes collide iff their intersection area is positive).
"""

import numpy as np

from . import box_ops
from .rotated_iou import box_to_corners, rotated_intersection_area


def box_collision_test(corners1, corners2):
    """[N, 4, 2] x [K, 4, 2] -> [N, K] bool: positive-area overlap."""
    n, k = corners1.shape[0], corners2.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=bool)
    su1 = box_ops.corner_to_standup_nd(corners1)
    su2 = box_ops.corner_to_standup_nd(corners2)
    gate = box_ops.iou(su1, su2, eps=0.0) > 0
    if not gate.any():
        return gate
    c1 = np.broadcast_to(corners1[:, None], (n, k, 4, 2))
    c2 = np.broadcast_to(corners2[None, :], (n, k, 4, 2))
    area = rotated_intersection_area(c1, c2)
    return gate & (area > 1e-10)


def _candidate_corners(boxes_bv, loc_noises, rot_noises):
    """All noised corner candidates [N, M, 4, 2] for BEV boxes [N, 5]."""
    n, m = rot_noises.shape
    corners = box_to_corners(boxes_bv)  # [N, 4, 2]
    centered = corners - boxes_bv[:, None, :2]
    # rotate each candidate by its noise (reference convention:
    # p @ [[c, -s], [s, c]])
    c = np.cos(rot_noises)
    s = np.sin(rot_noises)
    x, y = centered[..., 0], centered[..., 1]
    rx = x[:, None, :] * c[..., None] + y[:, None, :] * s[..., None]
    ry = -x[:, None, :] * s[..., None] + y[:, None, :] * c[..., None]
    rot = np.stack([rx, ry], axis=-1)  # [N, M, 4, 2]
    return rot + (boxes_bv[:, None, None, :2] + loc_noises[:, :, None, :2])


def noise_per_box(boxes_bv, valid_mask, loc_noises, rot_noises):
    """Sequential accept-first-non-colliding noise per box.

    boxes_bv: [N, 5]; loc_noises: [N, M, 3]; rot_noises: [N, M].
    Returns selected try index per box (-1 = keep original).
    """
    from ..native import host_ops

    return host_ops.noise_per_box(boxes_bv, valid_mask, loc_noises, rot_noises)


def _select_transform(transform, indices):
    result = np.zeros((transform.shape[0], *transform.shape[2:]),
                      dtype=transform.dtype)
    for i in range(transform.shape[0]):
        if indices[i] != -1:
            result[i] = transform[i, indices[i]]
    return result


def _placement(boxes_bv, global_rot_noises):
    """Rotate each box center around the scene origin by the global
    noise, preserving range (reference noise_per_box_v2_ placement:
    grot = arctan2(x, y), dst = r * (sin, cos)(grot + noise)).

    Returns dst [N, M, 2] and yaw delta dg [N, M].
    """
    x, y = boxes_bv[:, 0], boxes_bv[:, 1]
    r = np.sqrt(x * x + y * y)
    grot0 = np.arctan2(x, y)
    g = grot0[:, None] + global_rot_noises
    dst = np.stack([r[:, None] * np.sin(g), r[:, None] * np.cos(g)],
                   axis=-1)
    return dst, g - grot0[:, None]


def _candidate_corners_v2(boxes_bv, loc_noises, rot_noises,
                          global_rot_noises):
    """Candidates [N, M, 4, 2] with global-rotation placement. The two
    rotations (placement yaw delta, then per-object noise about the
    placed center) compose into one angle."""
    n, m = rot_noises.shape
    dst, dg = _placement(boxes_bv, global_rot_noises)
    centers = dst + loc_noises[:, :, :2]
    yaws = boxes_bv[:, None, 4] + dg + rot_noises
    flat = np.concatenate([
        centers.reshape(-1, 2),
        np.broadcast_to(boxes_bv[:, None, 2:4], (n, m, 2)).reshape(-1, 2),
        yaws.reshape(-1, 1),
    ], axis=1)
    return box_to_corners(flat).reshape(n, m, 4, 2), dst, dg


def noise_per_box_v2(boxes_bv, valid_mask, loc_noises, rot_noises,
                     global_rot_noises):
    """noise_per_box with global-rotation placement (reference
    noise_per_box_v2_, preprocess.py:394-449). Mutates loc/rot noises
    on success so the accepted transform includes the placement."""
    num_boxes = boxes_bv.shape[0]
    box_corners = box_to_corners(boxes_bv)
    candidates, dst, dg = _candidate_corners_v2(
        boxes_bv, loc_noises, rot_noises, global_rot_noises)
    success_mask = -np.ones((num_boxes,), dtype=np.int64)
    for i in range(num_boxes):
        if not valid_mask[i]:
            continue
        coll = box_collision_test(candidates[i], box_corners)
        coll[:, i] = False
        js = np.where(~coll.any(axis=1))[0]
        if len(js) > 0:
            j = js[0]
            success_mask[i] = j
            box_corners[i] = candidates[i, j]
            loc_noises[i, j, :2] += dst[i, j] - boxes_bv[i, :2]
            rot_noises[i, j] += dg[i, j]
    return success_mask


def _group_slices(group_nums):
    idx = 0
    for num in group_nums:
        yield idx, int(num)
        idx += int(num)


def noise_per_box_group(boxes_bv, valid_mask, loc_noises, rot_noises,
                        group_nums):
    """Group-coherent accept/reject: a whole group's candidate set must
    be collision-free together (reference noise_per_box_group,
    preprocess.py:277-315). Boxes must be contiguous per group."""
    num_boxes = boxes_bv.shape[0]
    box_corners = box_to_corners(boxes_bv)
    candidates = _candidate_corners(boxes_bv, loc_noises, rot_noises)
    success_mask = -np.ones((num_boxes,), dtype=np.int64)
    num_tries = rot_noises.shape[1]
    for idx, num in _group_slices(group_nums):
        if not valid_mask[idx]:
            continue
        for j in range(num_tries):
            coll = box_collision_test(
                candidates[idx:idx + num, j], box_corners)
            coll[:, idx:idx + num] = False
            if not coll.any():
                success_mask[idx:idx + num] = j
                box_corners[idx:idx + num] = candidates[idx:idx + num, j]
                break
    return success_mask


def noise_per_box_group_v2(boxes_bv, valid_mask, loc_noises, rot_noises,
                           group_nums, global_rot_noises):
    """Group-coherent noise with global-rotation placement (reference
    noise_per_box_group_v2_, preprocess.py:317-393)."""
    num_boxes = boxes_bv.shape[0]
    box_corners = box_to_corners(boxes_bv)
    candidates, dst, dg = _candidate_corners_v2(
        boxes_bv, loc_noises, rot_noises, global_rot_noises)
    success_mask = -np.ones((num_boxes,), dtype=np.int64)
    num_tries = rot_noises.shape[1]
    for idx, num in _group_slices(group_nums):
        if not valid_mask[idx]:
            continue
        for j in range(num_tries):
            coll = box_collision_test(
                candidates[idx:idx + num, j], box_corners)
            coll[:, idx:idx + num] = False
            if not coll.any():
                sl = slice(idx, idx + num)
                success_mask[sl] = j
                box_corners[sl] = candidates[sl, j]
                loc_noises[sl, j, :2] += dst[sl, j] - boxes_bv[sl, :2]
                rot_noises[sl, j] += dg[sl, j]
                break
    return success_mask


def set_group_noise_same_(loc_noise, rot_noise, group_ids,
                          grot_noise=None):
    """Every member of a group shares the first member's noise
    (reference set_group_noise_same_{,v2_}, preprocess.py:541-558)."""
    first = {}
    for i, gid in enumerate(group_ids):
        first.setdefault(gid, i)
    src = np.array([first[g] for g in group_ids])
    loc_noise[:] = loc_noise[src]
    rot_noise[:] = rot_noise[src]
    if grot_noise is not None:
        grot_noise[:] = grot_noise[src]


def get_group_center(locs, group_ids):
    """Per-box center of its group + per-group member counts in
    first-appearance order (reference preprocess.py:561-580)."""
    from collections import OrderedDict

    sums = OrderedDict()
    counts = OrderedDict()
    for i, gid in enumerate(group_ids):
        if gid < 0:
            continue
        if gid in sums:
            sums[gid] = sums[gid] + locs[i]
            counts[gid] += 1
        else:
            sums[gid] = locs[i].copy()
            counts[gid] = 1
    centers = np.zeros_like(locs)
    for i, gid in enumerate(group_ids):
        centers[i] = sums[gid] / counts[gid]
    return centers, counts


def group_transform_(loc_noise, rot_noise, locs, group_center, valid_mask,
                     grot_noise=None):
    """Make the per-object rotation orbit the GROUP center: adds the
    center-relative displacement to the location noise (reference
    group_transform_{,v2_}, preprocess.py:487-537)."""
    x = locs[:, 0] - group_center[:, 0]
    y = locs[:, 1] - group_center[:, 1]
    r = np.sqrt(x * x + y * y)
    rot_center = np.arctan2(x, y)
    base = rot_center[:, None]
    if grot_noise is not None:
        base = base + grot_noise
    add_x = r[:, None] * (np.sin(base + rot_noise) - np.sin(base))
    add_y = r[:, None] * (np.cos(base + rot_noise) - np.cos(base))
    vm = valid_mask[:, None]
    loc_noise[:, :, 0] += np.where(vm, add_x, 0.0)
    loc_noise[:, :, 1] += np.where(vm, add_y, 0.0)


def noise_per_object_v3_(gt_boxes,
                         points=None,
                         valid_mask=None,
                         rotation_perturb=np.pi / 4,
                         center_noise_std=1.0,
                         global_random_rot_range=np.pi / 4,
                         num_try=100,
                         group_ids=None):
    """Independently perturb each gt box (and its interior points) with
    collision-rejected location/rotation noise. In-place."""
    num_boxes = gt_boxes.shape[0]
    if num_boxes == 0:
        return
    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if not isinstance(global_random_rot_range, (list, tuple, np.ndarray)):
        global_random_rot_range = [
            -global_random_rot_range, global_random_rot_range
        ]
    enable_grot = (
        np.abs(global_random_rot_range[0] - global_random_rot_range[1])
        >= 1e-3)
    if not isinstance(center_noise_std, (list, tuple, np.ndarray)):
        center_noise_std = [center_noise_std] * 3
    if all(c == 0 for c in center_noise_std) and all(
            c == 0 for c in rotation_perturb) and not enable_grot:
        return
    if valid_mask is None:
        valid_mask = np.ones((num_boxes,), dtype=np.bool_)
    center_noise_std = np.array(center_noise_std, dtype=gt_boxes.dtype)
    loc_noises = np.random.normal(
        scale=center_noise_std, size=[num_boxes, num_try, 3])
    rot_noises = np.random.uniform(
        rotation_perturb[0], rotation_perturb[1], size=[num_boxes, num_try])
    global_rot_noises = None
    if enable_grot:
        # per-object placement noise relative to the box's bearing
        # (reference voxelnet semantics: grot range is absolute, so the
        # sampled delta is range - current bearing)
        gt_grots = np.arctan2(gt_boxes[:, 0], gt_boxes[:, 1])
        global_rot_noises = np.random.uniform(
            (global_random_rot_range[0] - gt_grots)[:, None],
            (global_random_rot_range[1] - gt_grots)[:, None],
            size=[num_boxes, num_try])

    group_nums = None
    if group_ids is not None:
        set_group_noise_same_(
            loc_noises, rot_noises, group_ids, grot_noise=global_rot_noises)
        group_centers, group_counts = get_group_center(
            gt_boxes[:, :3], group_ids)
        group_transform_(
            loc_noises, rot_noises, gt_boxes[:, :3], group_centers,
            valid_mask, grot_noise=global_rot_noises)
        group_nums = np.array(list(group_counts.values()), dtype=np.int64)

    # point membership BEFORE transforming (original box extents)
    gt_box_corners = box_ops.center_to_corner_box3d(
        gt_boxes[:, :3], gt_boxes[:, 3:6], gt_boxes[:, 6],
        origin=(0.5, 0.5, 0.5), axis=2)

    boxes_bv = gt_boxes[:, [0, 1, 3, 4, 6]]
    if group_ids is not None:
        if enable_grot:
            selected = noise_per_box_group_v2(
                boxes_bv, valid_mask, loc_noises, rot_noises, group_nums,
                global_rot_noises)
        else:
            selected = noise_per_box_group(
                boxes_bv, valid_mask, loc_noises, rot_noises, group_nums)
    elif enable_grot:
        selected = noise_per_box_v2(
            boxes_bv, valid_mask, loc_noises, rot_noises,
            global_rot_noises)
    else:
        selected = noise_per_box(
            boxes_bv, valid_mask, loc_noises, rot_noises)
    loc_transforms = _select_transform(loc_noises, selected)
    rot_transforms = _select_transform(rot_noises, selected)

    if points is not None:
        from . import geometry

        surfaces = box_ops.corner_to_surfaces_3d(gt_box_corners)
        point_masks = geometry.points_in_convex_polygon_3d(
            points[:, :3], surfaces)
        _points_transform(points, gt_boxes[:, :3], point_masks,
                          loc_transforms, rot_transforms, valid_mask)
    _box3d_transform(gt_boxes, loc_transforms, rot_transforms, valid_mask)


def _points_transform(points, centers, point_masks, loc_transform,
                      rot_transform, valid_mask):
    """Apply each box's accepted transform to its interior points
    (first containing box wins, reference points_transform_ :451-468)."""
    num_box = centers.shape[0]
    # first valid containing box per point
    masks = point_masks & valid_mask[np.newaxis, :]
    any_box = masks.any(axis=1)
    first_box = np.argmax(masks, axis=1)
    for j in range(num_box):
        if not valid_mask[j]:
            continue
        sel = any_box & (first_box == j)
        if not sel.any():
            continue
        pts = points[sel, :3] - centers[j, :3]
        ang = rot_transform[j]
        c, s = np.cos(ang), np.sin(ang)
        x, y = pts[:, 0].copy(), pts[:, 1].copy()
        pts[:, 0] = x * c + y * s
        pts[:, 1] = -x * s + y * c
        points[sel, :3] = pts + centers[j, :3] + loc_transform[j]


def _box3d_transform(boxes, loc_transform, rot_transform, valid_mask):
    boxes[valid_mask, :3] += loc_transform[valid_mask]
    boxes[valid_mask, 6] += rot_transform[valid_mask]


# ---------------------------------------------------------------------------
# global transforms (reference :745-907)
# ---------------------------------------------------------------------------


def random_flip(gt_boxes, points, probability=0.5, random_flip_x=True,
                random_flip_y=True):
    flip_x = np.random.choice(
        [False, True], replace=False, p=[1 - probability, probability])
    flip_y = np.random.choice(
        [False, True], replace=False, p=[1 - probability, probability])
    if flip_y and random_flip_y:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6] + np.pi
        if gt_boxes.shape[1] == 9:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
        points[:, 1] = -points[:, 1]
    if flip_x and random_flip_x:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        if gt_boxes.shape[1] == 9:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
        points[:, 0] = -points[:, 0]
    return gt_boxes, points


def global_scaling_v2(gt_boxes, points, min_scale=0.95, max_scale=1.05):
    noise_scale = np.random.uniform(min_scale, max_scale)
    points[:, :3] *= noise_scale
    gt_boxes[:, :6] *= noise_scale
    if gt_boxes.shape[1] == 9:
        gt_boxes[:, 7:] *= noise_scale
    return gt_boxes, points


def global_rotation_v2(gt_boxes, points, min_rad=-np.pi / 4,
                       max_rad=np.pi / 4):
    noise_rotation = np.random.uniform(min_rad, max_rad)
    points[:, :3] = box_ops.rotation_points_single_angle(
        points[:, :3], noise_rotation, axis=2)
    gt_boxes[:, :3] = box_ops.rotation_points_single_angle(
        gt_boxes[:, :3], noise_rotation, axis=2)
    gt_boxes[:, 6] += noise_rotation
    if gt_boxes.shape[1] == 9:
        rot_cos, rot_sin = np.cos(noise_rotation), np.sin(noise_rotation)
        rot_mat_T = np.array(
            [[rot_cos, -rot_sin], [rot_sin, rot_cos]], dtype=points.dtype)
        gt_boxes[:, 7:9] = gt_boxes[:, 7:9] @ rot_mat_T
    return gt_boxes, points


def global_translate_(gt_boxes, points, noise_translate_std):
    if not isinstance(noise_translate_std, (list, tuple, np.ndarray)):
        noise_translate_std = np.array([noise_translate_std] * 3)
    if all(e == 0 for e in noise_translate_std):
        return gt_boxes, points
    noise_translate = np.array([
        np.random.normal(0, noise_translate_std[0], 1),
        np.random.normal(0, noise_translate_std[1], 1),
        # NOTE upstream reuses std[0] for z (preprocess.py:893) — kept
        np.random.normal(0, noise_translate_std[0], 1),
    ]).T
    points[:, :3] += noise_translate
    gt_boxes[:, :3] += noise_translate
    return gt_boxes, points


def filter_gt_box_outside_range_by_center(gt_boxes, limit_range):
    """Keep boxes whose BEV center is inside the limit rect (the filter
    prep_pointcloud actually uses, reference preprocess.py:153-164)."""
    c = gt_boxes[:, :2]
    return (
        (c[:, 0] > limit_range[0]) & (c[:, 0] < limit_range[2])
        & (c[:, 1] > limit_range[1]) & (c[:, 1] < limit_range[3])
    )


def filter_gt_box_outside_range(gt_boxes, limit_range):
    """Keep boxes whose BEV center region intersects the limit rect
    (reference filter_gt_box_outside_range)."""
    gt_boxes_bv = box_ops.center_to_corner_box2d(
        gt_boxes[:, :2], gt_boxes[:, 3:5], gt_boxes[:, 6])
    bounding_box = np.array(
        [[limit_range[0], limit_range[1]], [limit_range[0], limit_range[3]],
         [limit_range[2], limit_range[3]], [limit_range[2], limit_range[1]]])
    ret = np.zeros(gt_boxes.shape[0], dtype=bool)
    for i in range(gt_boxes.shape[0]):
        # any corner inside the range rect, or center inside
        corners = gt_boxes_bv[i]
        inside = (
            (corners[:, 0] >= limit_range[0])
            & (corners[:, 0] <= limit_range[2])
            & (corners[:, 1] >= limit_range[1])
            & (corners[:, 1] <= limit_range[3])
        )
        ret[i] = inside.any()
    del bounding_box
    return ret
