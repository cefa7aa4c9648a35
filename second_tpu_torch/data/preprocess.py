"""THE preprocessing pipeline: raw sensor dict -> training example.

The port's copy of ``second_tpu/data/preprocess.py``, a behavioural
port of second/data/preprocess.py:99-408 (prep_pointcloud): every
example uses the fixed-shape padding contract (the reference's
multi-GPU variant, preprocess.py:57-88 + generate_multi_gpu
voxelization) — voxels [Vmax, T, F], coordinates [Vmax, 3] zyx with -1
padding rows, so batches stack into static shapes.

The augmentation makes the same ``np.random`` draws in the same order
as the JAX package's, so one seed gives both packages the same example
(the GT-database sampler's draws included). Left out of the copy:
int16-quantized points (``quantize_points`` raises) and the banded
rulebook plans.
"""

import os
import sys
import warnings

import numpy as np

from ..core import box_ops
from ..core import preprocess as prep
from ..native import host_ops
from ..utils import timer
from . import kitti_common as kitti

# the serving module, which calls prep_pointcloud for a request
_SERVING = os.path.join(os.path.dirname(os.path.dirname(__file__)), "core",
                        "inference.py")


def _dict_select(dict_, inds):
    for k, v in dict_.items():
        if isinstance(v, dict):
            _dict_select(v, inds)
        else:
            dict_[k] = v[inds]


def pad_points(points, pc_range, capacity, dtype=np.float32):
    """The points inside ``pc_range`` (``pc_range[:3] <= xyz <
    pc_range[3:]``), in their original order, in a zero-padded
    [capacity, F] buffer, and their count (at most ``capacity``).

    Out-of-range points never form a voxel, so dropping them first
    changes none; it keeps them from crowding in-range points out of the
    buffer (a raw KITTI scan holds ~120k points). Past the capacity the
    later points are dropped, with a warning attributed to the caller of
    the caller (``prep_pointcloud``'s; a request's own caller, past
    ``core/inference.py``).

    One native pass (``native.host_ops.pad_points``) reads each row once;
    the comparison runs in the dtype NumPy would promote ``points`` and
    ``pc_range`` to, so a point on a face, or a NaN, lands where
    ``np.all((xyz >= lo) & (xyz < hi), axis=1)`` puts it.
    """
    buf, total = host_ops.pad_points(points, pc_range, capacity, dtype)
    if total > capacity:
        # past the serving module's frames, a request's warning names the
        # request's caller (walked here: CPython 3.12's C warnings kept
        # them under skip_file_prefixes)
        level, frame = 3, sys._getframe(2)
        while frame is not None and frame.f_code.co_filename == _SERVING:
            level, frame = level + 1, frame.f_back
        warnings.warn(
            f"emit_points buffer overflow: {total} in-range "
            f"points > capacity {capacity}; "
            f"{total - capacity} dropped (raise emit_points)",
            stacklevel=level)
    return buf, min(total, capacity)


def sort_by_linear_id(example, shape):
    """Reorder the example's "voxels", "num_points" and "coordinates"
    (in place) by the voxels' linear zyx ids in the (D, H, W) grid
    ``shape``, the -1 padding rows last in their own order: the order
    the host planner reads and the device's sparse grid keeps. Returns
    the sorted coordinates.

    A voxelizer gives each voxel one row, so the ids are distinct; the
    padding rows take distinct ids past the grid, in row order. With no
    ties any sort is the stable one, and NumPy's default sort takes less
    than half the time of its stable one on int64 keys."""
    d, h, w = shape
    coordinates = example["coordinates"]
    lin = np.where(
        coordinates[:, 0] >= 0,
        (coordinates[:, 0].astype(np.int64) * h + coordinates[:, 1]) * w
        + coordinates[:, 2],
        d * h * w + np.arange(len(coordinates)))
    order = np.argsort(lin)
    for key in ("voxels", "num_points", "coordinates"):
        example[key] = example[key].take(order, axis=0)
    return example["coordinates"]


def prep_pointcloud(input_dict,
                    voxel_generator,
                    target_assigner,
                    root_path="",
                    db_sampler=None,
                    max_voxels=20000,
                    remove_outside_points=False,
                    training=True,
                    create_targets=True,
                    shuffle_points=False,
                    remove_unknown=False,
                    gt_rotation_noise=(-np.pi / 3, np.pi / 3),
                    gt_loc_noise_std=(1.0, 1.0, 1.0),
                    global_rotation_noise=(-np.pi / 4, np.pi / 4),
                    global_scaling_noise=(0.95, 1.05),
                    global_random_rot_range=(0.78, 2.35),
                    global_translate_noise_std=(0, 0, 0),
                    num_point_features=4,
                    anchor_area_threshold=1,
                    remove_points_after_sample=True,
                    anchor_cache=None,
                    remove_environment=False,
                    random_crop=False,
                    reference_detections=None,
                    out_size_factor=2,
                    use_group_id=False,
                    min_points_in_gt=-1,
                    random_flip_x=True,
                    random_flip_y=True,
                    sample_importance=1.0,
                    sparse_plan_scales=None,
                    emit_points=0,
                    quantize_points=False,
                    compact_targets=False,
                    pos_capacity=1024,
                    out_dtype=np.float32):
    """Returns a fixed-shape example dict.

    db_sampler: optional ``core.sample_ops.DataBaseSamplerV2`` (training
    only): pastes GT-database objects (their points read under
    ``root_path``) into the frame before the per-object noise; the
    pasted boxes weigh ``sample_importance`` in the loss, and with
    ``remove_points_after_sample`` the frame's points inside them are
    dropped first. ``random_crop`` crops an image-plane sub-frustum out
    of each pasted object (needs the calib).

    sparse_plan_scales: optional output of
    ``models.sparse_middle.plan_scales`` — when given, voxels are sorted
    by linear id (:func:`sort_by_linear_id`) and C++-built sparse-conv
    rulebooks (plan_* int32 arrays) are added to the example. The
    training and evaluation loaders pass it for sparse middles on host
    voxels (their route, ``builders.route``); a request passes None,
    sorts its voxels alone and has its rulebooks built on the device.

    emit_points: if > 0, ship the augmented point cloud itself
    ("points" [emit_points, F], the in-range points padded by
    :func:`pad_points`, + "points_count") INSTEAD of the padded voxel
    buffer, for models that voxelize on the device (the PointPillars
    family). The host voxelizer then runs only for the anchor mask
    (``anchor_area_threshold >= 0``), and the example keeps its
    "num_voxels"; without the mask nothing reads host voxels, so none
    are made and "num_voxels" is not shipped. Exclusive with
    sparse_plan_scales (the planner needs host voxels).

    compact_targets: ship per-anchor labels as int8 plus ONLY the
    positive anchors' regression targets ("pos_idx"/"pos_targets"/
    "pos_count", capacity ``pos_capacity``) instead of the dense
    [A, code] buffer; the train step scatters them back
    (``train/state.py``). Positives past the capacity are marked
    don't-care, with a warning; "pos_count" reports them all.

    Stages (``utils.timer``): "prep.voxelize" from the entry through the
    voxelizer and the point buffer, "prep.plan" for the sort and the
    rulebooks, "prep.anchor_mask" for the anchors and their mask; the
    shipped points and the buffer's rows count as "points_shipped" /
    "points_capacity", the planner's summed (true_active, capacity) as
    "sparse_rows_active" / "sparse_rows_capacity", and "host_voxelized"
    counts 1 where the host voxelizer ran, else 0.
    """
    if quantize_points:
        raise NotImplementedError(
            "int16-quantized points (data/point_quant.py) are not ported; "
            "ship f32 points")
    try:
        timer.stage("prep.voxelize")
        class_names = target_assigner.classes
        points = input_dict["lidar"]["points"]
        if training:
            anno_dict = input_dict["lidar"]["annotations"]
            gt_dict = {
                "gt_boxes": anno_dict["boxes"],
                "gt_names": anno_dict["names"],
                "gt_importance": np.ones(
                    [anno_dict["boxes"].shape[0]],
                    dtype=anno_dict["boxes"].dtype),
            }
            if "difficulty" not in anno_dict:
                gt_dict["difficulty"] = np.zeros(
                    [anno_dict["boxes"].shape[0]], dtype=np.int32)
            else:
                gt_dict["difficulty"] = anno_dict["difficulty"]
            if use_group_id and "group_ids" in anno_dict:
                gt_dict["group_ids"] = anno_dict["group_ids"]
        calib = input_dict.get("calib")

        if reference_detections is not None:
            # keep only points inside the frustums of reference 2D
            # detections (reference data/preprocess.py:162-171)
            assert calib is not None
            frustums = box_ops.image_bboxes_to_lidar_frustums(
                reference_detections, calib["rect"], calib["Trv2c"],
                calib["P2"])
            masks = box_ops.mask_points_in_corners(points, frustums)
            points = points[masks.any(-1)]

        if remove_outside_points:
            assert calib is not None
            image_shape = input_dict["image"]["image_shape"]
            points = box_ops.remove_outside_points(
                points, calib["rect"], calib["Trv2c"], calib["P2"],
                image_shape)
        if remove_environment is True and training:
            selected = kitti.keep_arrays_by_name(
                gt_dict["gt_names"], target_assigner.classes)
            _dict_select(gt_dict, selected)
            masks = box_ops.points_in_rbbox(points, gt_dict["gt_boxes"])
            points = points[masks.any(-1)]

        if training:
            selected = kitti.drop_arrays_by_name(gt_dict["gt_names"],
                                                 ["DontCare"])
            _dict_select(gt_dict, selected)
            if remove_unknown:
                keep_mask = np.logical_not(gt_dict["difficulty"] == -1)
                _dict_select(gt_dict, keep_mask)
            gt_dict.pop("difficulty")
            if min_points_in_gt > 0:
                point_counts = box_ops.points_count_rbbox(
                    points, gt_dict["gt_boxes"])
                _dict_select(gt_dict, point_counts >= min_points_in_gt)
            gt_boxes_mask = np.array(
                [n in class_names for n in gt_dict["gt_names"]],
                dtype=np.bool_)
            if db_sampler is not None:
                group_ids = gt_dict.get("group_ids")
                sampled_dict = db_sampler.sample_all(
                    root_path, gt_dict["gt_boxes"], gt_dict["gt_names"],
                    num_point_features, random_crop, gt_group_ids=group_ids,
                    calib=calib)
                if sampled_dict is not None:
                    sampled_gt_boxes = sampled_dict["gt_boxes"]
                    gt_dict["gt_names"] = np.concatenate(
                        [gt_dict["gt_names"], sampled_dict["gt_names"]],
                        axis=0)
                    gt_dict["gt_boxes"] = np.concatenate(
                        [gt_dict["gt_boxes"], sampled_gt_boxes])
                    gt_boxes_mask = np.concatenate(
                        [gt_boxes_mask, sampled_dict["gt_masks"]], axis=0)
                    gt_dict["gt_importance"] = np.concatenate([
                        gt_dict["gt_importance"],
                        np.full([sampled_gt_boxes.shape[0]], sample_importance,
                                dtype=sampled_gt_boxes.dtype),
                    ])
                    if group_ids is not None:
                        gt_dict["group_ids"] = np.concatenate(
                            [gt_dict["group_ids"], sampled_dict["group_ids"]])
                    if remove_points_after_sample:
                        masks = box_ops.points_in_rbbox(points,
                                                        sampled_gt_boxes)
                        points = points[np.logical_not(masks.any(-1))]
                    points = np.concatenate(
                        [sampled_dict["points"], points], axis=0)
            prep.noise_per_object_v3_(
                gt_dict["gt_boxes"],
                points,
                gt_boxes_mask,
                rotation_perturb=gt_rotation_noise,
                center_noise_std=gt_loc_noise_std,
                global_random_rot_range=global_random_rot_range,
                group_ids=gt_dict.get("group_ids"),
                num_try=100)
            _dict_select(gt_dict, gt_boxes_mask)
            gt_dict["gt_classes"] = np.array(
                [class_names.index(n) + 1 for n in gt_dict["gt_names"]],
                dtype=np.int32)
            gt_dict["gt_boxes"], points = prep.random_flip(
                gt_dict["gt_boxes"], points, 0.5, random_flip_x, random_flip_y)
            gt_dict["gt_boxes"], points = prep.global_rotation_v2(
                gt_dict["gt_boxes"], points, *global_rotation_noise)
            gt_dict["gt_boxes"], points = prep.global_scaling_v2(
                gt_dict["gt_boxes"], points, *global_scaling_noise)
            prep.global_translate_(
                gt_dict["gt_boxes"], points, global_translate_noise_std)
            bv_range = voxel_generator.point_cloud_range[[0, 1, 3, 4]]
            mask = prep.filter_gt_box_outside_range_by_center(
                gt_dict["gt_boxes"], bv_range)
            _dict_select(gt_dict, mask)
            gt_dict["gt_boxes"][:, 6] = box_ops.limit_period(
                gt_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi)
        if shuffle_points:
            np.random.shuffle(points)

        voxel_size = voxel_generator.voxel_size
        pc_range = voxel_generator.point_cloud_range
        grid_size = voxel_generator.grid_size

        assert not (emit_points and sparse_plan_scales is not None), (
            "emit_points is for device-voxelizing models; the sparse "
            "middle family needs host voxels for the rulebook planner")
        # the host voxels are read by a voxel route and by the anchor
        # mask; a points route without the mask ships and reads none
        host_voxels = not emit_points or anchor_area_threshold >= 0
        timer.count("host_voxelized", int(host_voxels))
        example = {}
        if host_voxels:
            res = voxel_generator.generate_multi_gpu(points, max_voxels)
            voxels = res["voxels"].astype(out_dtype)
            coordinates = res["coordinates"].copy()
            num_points = res["num_points_per_voxel"]
            num_voxels = int(res["voxel_num"])
            # -1-pad the empty coordinate rows (static-shape validity
            # marker)
            coordinates[num_voxels:] = -1
            example = {
                "voxels": voxels,
                "num_points": num_points,
                "coordinates": coordinates,
                "num_voxels": np.array([num_voxels], dtype=np.int64),
            }
        if emit_points:
            buf, count = pad_points(points, pc_range, emit_points, out_dtype)
            example["points"] = buf
            example["points_count"] = np.array([count], np.int32)
            timer.count("points_shipped", count)
            timer.count("points_capacity", emit_points)
            # the padded voxel buffer is ~100x the points' bytes; the
            # device re-voxelizes inside the train step
            for key in ("voxels", "num_points", "coordinates"):
                example.pop(key, None)
        if sparse_plan_scales is not None:
            timer.stage("prep.plan")
            # host-built rulebooks need voxels sorted by linear id
            coordinates = sort_by_linear_id(
                example, sparse_plan_scales[0]["shape"])
            from ..models.sparse_middle import build_host_plan

            plan, counts = build_host_plan(
                coordinates, sparse_plan_scales, return_counts=True)
            example.update(plan)
            # per-downsample-stage (true_active, capacity) — spconv never
            # drops voxels (middle.py:199-209); the train loop surfaces
            # utilization so capacity overflow is visible, not silent
            active = np.array([counts[i] for i in sorted(counts)],
                              dtype=np.int32)
            example["sparse_active_counts"] = active
            timer.count("sparse_rows_active", int(active[:, 0].sum()))
            timer.count("sparse_rows_capacity", int(active[:, 1].sum()))
        if calib is not None:
            example["calib"] = calib
        timer.stage("prep.anchor_mask")
        feature_map_size = grid_size[:2] // out_size_factor
        feature_map_size = [*feature_map_size, 1][::-1]
        if anchor_cache is not None:
            anchors = anchor_cache["anchors"]
            anchors_bv = anchor_cache["anchors_bv"]
            anchors_dict = anchor_cache["anchors_dict"]
            matched_thresholds = anchor_cache["matched_thresholds"]
            unmatched_thresholds = anchor_cache["unmatched_thresholds"]
        else:
            ret = target_assigner.generate_anchors(feature_map_size)
            anchors = ret["anchors"].reshape([-1, target_assigner.box_ndim])
            anchors_dict = target_assigner.generate_anchors_dict(
                feature_map_size)
            anchors_bv = box_ops.rbbox2d_to_near_bbox(
                anchors[:, [0, 1, 3, 4, 6]])
            matched_thresholds = ret["matched_thresholds"]
            unmatched_thresholds = ret["unmatched_thresholds"]
        # the cache itself where its dtype is out_dtype: a run's requests
        # share one read-only array (the device keeps a resident copy)
        example["anchors"] = anchors.astype(out_dtype, copy=False)
        anchors_mask = None
        if anchor_area_threshold >= 0:
            # occupancy-gated anchors via BEV summed-area table
            coors = coordinates[:num_voxels]
            dense_voxel_map = box_ops.sparse_sum_for_anchors_mask(
                coors, tuple(grid_size[::-1][1:]))
            dense_voxel_map = dense_voxel_map.cumsum(0).cumsum(1)
            anchors_area = box_ops.fused_get_anchors_area(
                dense_voxel_map, anchors_bv, voxel_size, pc_range, grid_size)
            anchors_mask = anchors_area > anchor_area_threshold
            example["anchors_mask"] = anchors_mask
        timer.stage(None)
        if not training:
            return example
        example["gt_names"] = gt_dict["gt_names"]
        if create_targets:
            targets_dict = target_assigner.assign(
                anchors,
                anchors_dict,
                gt_dict["gt_boxes"],
                anchors_mask,
                gt_classes=gt_dict["gt_classes"],
                gt_names=gt_dict["gt_names"],
                matched_thresholds=matched_thresholds,
                unmatched_thresholds=unmatched_thresholds,
                importance=gt_dict["gt_importance"])
            labels = targets_dict["labels"]
            reg_targets = targets_dict["bbox_targets"].astype(out_dtype)
            if compact_targets:
                # dense [A, code] reg targets are ~6 MB of zeros per
                # example; ship only the positive rows + int8 labels
                (pos,) = np.nonzero(labels > 0)
                n_pos = len(pos)
                pos_idx = np.full(pos_capacity, len(labels), np.int32)
                pos_tgt = np.zeros((pos_capacity, reg_targets.shape[1]),
                                   np.float32)
                m = min(n_pos, pos_capacity)
                pos_idx[:m] = pos[:m]
                pos_tgt[:m] = reg_targets[pos[:m]]
                if n_pos > pos_capacity:
                    # truncated positives would otherwise train toward
                    # zero box offsets — drop them from BOTH losses
                    labels = labels.copy()
                    labels[pos[m:]] = -1  # "don't care" (cared mask excludes)
                    warnings.warn(
                        f"compact_targets overflow: {n_pos} positive anchors "
                        f"> pos_capacity {pos_capacity}; {n_pos - m} marked "
                        "don't-care (raise pos_capacity)", stacklevel=2)
                example.update({
                    "labels_i8": labels.astype(np.int8),
                    "pos_idx": pos_idx,
                    "pos_targets": pos_tgt,
                    "pos_count": np.array([n_pos], np.int32),
                })
            else:
                example.update({
                    "labels": labels,
                    "reg_targets": reg_targets,
                })
            example["importance"] = targets_dict["importance"].astype(
                out_dtype)
        return example
    finally:
        timer.stage(None)


def _stack(elems):
    # a batch of one is a view of its example's array: no copy
    if len(elems) == 1:
        return np.asarray(elems[0])[None]
    return np.stack(elems, axis=0)


def merge_second_batch(batch_list):
    """Stack fixed-shape examples into a batch (the static-shape twin of
    reference merge_second_batch_multigpu, preprocess.py:57-88). A batch
    of one example holds views of its arrays, which share their memory
    (and a read-only array's flag)."""
    keys = batch_list[0].keys()
    ret = {}
    for key in keys:
        elems = [e[key] for e in batch_list]
        if key in ("metadata", "metrics", "gt_names"):
            ret[key] = elems
        elif key == "calib":
            ret[key] = {k1: _stack([e[k1] for e in elems])
                        for k1 in elems[0]}
        else:
            ret[key] = _stack(elems)
    return ret
