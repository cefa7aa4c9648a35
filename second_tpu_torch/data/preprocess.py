"""THE preprocessing pipeline: raw sensor dict -> training example.

The port's copy of ``second_tpu/data/preprocess.py``, a behavioural
port of second/data/preprocess.py:99-408 (prep_pointcloud): every
example uses the fixed-shape padding contract (the reference's
multi-GPU variant, preprocess.py:57-88 + generate_multi_gpu
voxelization) — voxels [Vmax, T, F], coordinates [Vmax, 3] zyx with -1
padding rows, so batches stack into static shapes.

The augmentation makes the same ``np.random`` draws in the same order
as the JAX package's, so one seed gives both packages the same example.
Left out of the copy: the GT-database sampler (``db_sampler`` must be
None), point shipping for device voxelizers (``emit_points``), the
banded rulebook plans and ``compact_targets``.
"""

import time

import numpy as np

from ..core import box_ops
from ..core import preprocess as prep
from . import kitti_common as kitti


def _dict_select(dict_, inds):
    for k, v in dict_.items():
        if isinstance(v, dict):
            _dict_select(v, inds)
        else:
            dict_[k] = v[inds]


def prep_pointcloud(input_dict,
                    voxel_generator,
                    target_assigner,
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
                    anchor_cache=None,
                    remove_environment=False,
                    reference_detections=None,
                    out_size_factor=2,
                    use_group_id=False,
                    min_points_in_gt=-1,
                    random_flip_x=True,
                    random_flip_y=True,
                    sparse_plan_scales=None,
                    out_dtype=np.float32):
    """Returns a fixed-shape example dict.

    sparse_plan_scales: optional output of
    ``models.sparse_middle.plan_scales`` — when given, voxels are sorted
    by linear id and C++-built sparse-conv rulebooks (plan_* int32
    arrays) are added to the example.
    """
    if db_sampler is not None:
        raise NotImplementedError(
            "the GT-database sampler is not ported yet; pass db_sampler=None")
    t = time.time()
    class_names = target_assigner.classes
    points = input_dict["lidar"]["points"]
    if training:
        anno_dict = input_dict["lidar"]["annotations"]
        gt_dict = {
            "gt_boxes": anno_dict["boxes"],
            "gt_names": anno_dict["names"],
            "gt_importance": np.ones(
                [anno_dict["boxes"].shape[0]], dtype=anno_dict["boxes"].dtype),
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
            points, calib["rect"], calib["Trv2c"], calib["P2"], image_shape)
    if remove_environment is True and training:
        selected = kitti.keep_arrays_by_name(
            gt_dict["gt_names"], target_assigner.classes)
        _dict_select(gt_dict, selected)
        masks = box_ops.points_in_rbbox(points, gt_dict["gt_boxes"])
        points = points[masks.any(-1)]
    metrics = {}

    if training:
        selected = kitti.drop_arrays_by_name(gt_dict["gt_names"], ["DontCare"])
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
            [n in class_names for n in gt_dict["gt_names"]], dtype=np.bool_)
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

    t1 = time.time()
    res = voxel_generator.generate_multi_gpu(points, max_voxels)
    voxels = res["voxels"].astype(out_dtype)
    coordinates = res["coordinates"].copy()
    num_points = res["num_points_per_voxel"]
    num_voxels = int(res["voxel_num"])
    # -1-pad the empty coordinate rows (static-shape validity marker)
    coordinates[num_voxels:] = -1
    metrics["voxel_gene_time"] = time.time() - t1

    example = {
        "voxels": voxels,
        "num_points": num_points,
        "coordinates": coordinates,
        "num_voxels": np.array([num_voxels], dtype=np.int64),
        "metrics": metrics,
    }
    if sparse_plan_scales is not None:
        # host-built rulebooks need voxels sorted by linear id
        d, h, w = sparse_plan_scales[0]["shape"]
        lin = np.where(
            coordinates[:, 0] >= 0,
            (coordinates[:, 0].astype(np.int64) * h + coordinates[:, 1])
            * w + coordinates[:, 2],
            d * h * w)
        order = np.argsort(lin, kind="stable")
        voxels = voxels[order]
        coordinates = coordinates[order]
        num_points = num_points[order]
        example["voxels"] = voxels
        example["coordinates"] = coordinates
        example["num_points"] = num_points
        from ..models.sparse_middle import build_host_plan

        plan, counts = build_host_plan(
            coordinates, sparse_plan_scales, return_counts=True)
        example.update(plan)
        # per-downsample-stage (true_active, capacity) — spconv never
        # drops voxels (middle.py:199-209); the train loop surfaces
        # utilization so capacity overflow is visible, not silent
        example["sparse_active_counts"] = np.array(
            [counts[i] for i in sorted(counts)], dtype=np.int32)
    if calib is not None:
        example["calib"] = calib
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
        anchors_dict = target_assigner.generate_anchors_dict(feature_map_size)
        anchors_bv = box_ops.rbbox2d_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]])
        matched_thresholds = ret["matched_thresholds"]
        unmatched_thresholds = ret["unmatched_thresholds"]
    example["anchors"] = anchors.astype(out_dtype)
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
    metrics["prep_time"] = time.time() - t
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
        example.update({
            "labels": targets_dict["labels"],
            "reg_targets": targets_dict["bbox_targets"].astype(out_dtype),
        })
        example["importance"] = targets_dict["importance"].astype(
            out_dtype)
    return example


def merge_second_batch(batch_list):
    """Stack fixed-shape examples into a batch (the static-shape twin of
    reference merge_second_batch_multigpu, preprocess.py:57-88)."""
    keys = batch_list[0].keys()
    ret = {}
    for key in keys:
        elems = [e[key] for e in batch_list]
        if key in ("metadata", "metrics", "gt_names"):
            ret[key] = elems
        elif key == "calib":
            ret[key] = {
                k1: np.stack([e[k1] for e in elems], axis=0)
                for k1 in elems[0]
            }
        else:
            ret[key] = np.stack(elems, axis=0)
    return ret
