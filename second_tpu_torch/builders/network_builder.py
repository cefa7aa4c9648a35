"""Config -> (torch network, ModelSpec) (twin of
``second_tpu/builders/network_builder.py``).

``build_network(pipeline_cfg, device)`` builds the voxel generator, box
coder, target assigner, anchors, the network on ``device`` (in eval
mode) and the static ModelSpec of the loss and the predict
post-process.
"""

import numpy as np
import torch

from ..configs import schema
from ..core import box_ops
from ..core.box_coders import BevBoxCoder
from ..utils.config_tool import get_downsample_factor

from .. import models  # noqa: F401  (registers the modules)
from ..models.registry import get_voxelnet_class
from ..models.voxelnet import ModelSpec
from ..ops import losses as L
from . import (
    box_coder_builder,
    losses_builder,
    target_assigner_builder,
    voxel_builder,
)


def _nms_params(ta_cfg: schema.TargetAssigner):
    classes_cfg = ta_cfg.class_settings
    num_class = len(classes_cfg)

    def per_class(override, attr):
        if len(override) != 0:
            if len(override) != num_class:
                raise ValueError(f"{attr}: one value per class expected")
            return list(override)
        return [getattr(c, attr) for c in classes_cfg]

    use_mcnms = [c.use_multi_class_nms for c in classes_cfg]
    use_rot = [c.use_rotate_nms for c in classes_cfg]
    if not (all(use_mcnms) or not any(use_mcnms)):
        raise ValueError("mixed multiclass nms")
    if not (all(use_rot) or not any(use_rot)):
        raise ValueError("mixed rotate nms")
    pre = per_class(ta_cfg.nms_pre_max_sizes, "nms_pre_max_size")
    post = per_class(ta_cfg.nms_post_max_sizes, "nms_post_max_size")
    score = per_class(ta_cfg.nms_score_thresholds, "nms_score_threshold")
    iou = per_class(ta_cfg.nms_iou_thresholds, "nms_iou_threshold")
    if not any(use_mcnms):
        for vals in (pre, post, score, iou):
            if len(set(vals)) != 1:
                raise ValueError("single-class-set NMS needs one setting "
                                 "for all classes")
    return all(use_mcnms), all(use_rot), pre, post, score, iou


def build_model_spec(model_cfg: schema.VoxelNet, target_assigner):
    cls_loss_fn, loc_loss_fn, cls_w, loc_w = losses_builder.build(
        model_cfg.loss)
    mcnms, rot_nms, pre, post, score, iou = _nms_params(
        model_cfg.target_assigner)
    box_coder = target_assigner.box_coder
    num_class = len(model_cfg.target_assigner.class_settings)
    anchors_ranges = tuple(
        tuple(int(v) for v in target_assigner.anchors_range(i))
        for i in range(num_class))
    return ModelSpec(
        num_class=num_class,
        box_code_size=box_coder.code_size,
        num_anchor_per_loc=target_assigner.num_anchors_per_location,
        cls_loss_fn=cls_loss_fn,
        loc_loss_fn=loc_loss_fn,
        dir_loss_fn=L.weighted_softmax_loss,
        cls_loss_weight=cls_w,
        loc_loss_weight=loc_w,
        direction_loss_weight=model_cfg.direction_loss_weight,
        pos_cls_weight=model_cfg.pos_class_weight,
        neg_cls_weight=model_cfg.neg_class_weight,
        loss_norm_type=int(model_cfg.loss_norm_type),
        encode_rad_error_by_sin=model_cfg.encode_rad_error_by_sin,
        sin_error_factor=model_cfg.sin_error_factor or 1.0,
        encode_background_as_zeros=model_cfg.encode_background_as_zeros,
        use_sigmoid_score=model_cfg.use_sigmoid_score,
        use_direction_classifier=model_cfg.use_direction_classifier,
        num_direction_bins=model_cfg.num_direction_bins or 2,
        dir_offset=model_cfg.direction_offset,
        dir_limit_offset=model_cfg.direction_limit_offset,
        linear_dim=getattr(box_coder, "linear_dim", False),
        vec_encode=getattr(box_coder, "vec_encode", False),
        bev_coder=isinstance(box_coder, BevBoxCoder),
        bev_z_fixed=getattr(box_coder, "z_fixed", -1.0),
        bev_h_fixed=getattr(box_coder, "h_fixed", 2.0),
        use_rotate_nms=rot_nms,
        multiclass_nms=mcnms,
        nms_class_agnostic=model_cfg.nms_class_agnostic,
        nms_score_thresholds=tuple(score),
        nms_pre_max_sizes=tuple(int(v) for v in pre),
        nms_post_max_sizes=tuple(int(v) for v in post),
        nms_iou_thresholds=tuple(iou),
        post_center_range=tuple(model_cfg.post_center_limit_range),
        anchors_ranges=anchors_ranges,
    )


def build_network(config, device, compute_dtype=None):
    """Pipeline config (or model.second config) -> dict of parts; the
    network is on ``device`` and in eval mode, its parameters f32.

    compute_dtype: None (f32) or "bfloat16" (``VoxelNet``'s mixed
    precision); None on a pipeline config whose
    ``train_config.enable_mixed_precision`` is set means "bfloat16", as
    in the JAX package."""
    if isinstance(config, schema.TrainEvalPipelineConfig):
        model_cfg = config.model.second
        if (compute_dtype is None
                and config.train_config.enable_mixed_precision):
            compute_dtype = "bfloat16"
    else:
        model_cfg = config
    voxel_generator = voxel_builder.build(model_cfg.voxel_generator)
    box_coder = box_coder_builder.build(model_cfg.box_coder)
    target_assigner = target_assigner_builder.build(
        model_cfg.target_assigner, box_coder)

    vfe_num_filters = list(model_cfg.voxel_feature_extractor.num_filters)
    grid_size = voxel_generator.grid_size
    dense_shape = [1] + grid_size[::-1].tolist() + [vfe_num_filters[-1]]
    out_size_factor = get_downsample_factor(model_cfg)
    feature_map_size = grid_size[:2] // out_size_factor
    feature_map_size = [*feature_map_size, 1][::-1]
    anchor_cache = make_anchor_cache(
        target_assigner, feature_map_size, grid_size)
    spec = build_model_spec(model_cfg, target_assigner)

    mid = model_cfg.middle_feature_extractor
    rpn = model_cfg.rpn
    extra = {}
    if model_cfg.network_class_name == "VoxelNetNuscenesMultiHead":
        extra = dict(
            class_names=tuple(target_assigner.classes),
            num_anchor_per_loc_by_class=tuple(
                int(target_assigner.num_anchors_per_location_class(c))
                for c in target_assigner.classes))
    net = get_voxelnet_class(model_cfg.network_class_name)(
        **extra,
        output_shape=tuple(dense_shape),
        num_class=spec.num_class,
        num_input_features=model_cfg.num_point_features,
        vfe_class_name=model_cfg.voxel_feature_extractor.module_class_name,
        vfe_num_filters=tuple(vfe_num_filters),
        with_distance=model_cfg.voxel_feature_extractor.with_distance,
        middle_class_name=mid.module_class_name,
        middle_num_input_features=mid.num_input_features,
        middle_num_filters_d1=tuple(mid.num_filters_down1),
        middle_num_filters_d2=tuple(mid.num_filters_down2),
        rpn_class_name=rpn.module_class_name,
        rpn_num_input_features=rpn.num_input_features,
        rpn_layer_nums=tuple(rpn.layer_nums),
        rpn_layer_strides=tuple(rpn.layer_strides),
        rpn_num_filters=tuple(rpn.num_filters),
        rpn_upsample_strides=tuple(rpn.upsample_strides),
        rpn_num_upsample_filters=tuple(rpn.num_upsample_filters),
        use_groupnorm=rpn.use_groupnorm,
        num_groups=rpn.num_groups,
        use_direction_classifier=model_cfg.use_direction_classifier,
        encode_background_as_zeros=model_cfg.encode_background_as_zeros,
        num_direction_bins=spec.num_direction_bins,
        num_anchor_per_loc=spec.num_anchor_per_loc,
        box_code_size=spec.box_code_size,
        voxel_size=tuple(voxel_generator.voxel_size.tolist()),
        pc_range=tuple(voxel_generator.point_cloud_range.tolist()),
        use_norm=True,
        compute_dtype=compute_dtype,
    ).to(torch.device(device)).eval()
    return {
        "net": net,
        "spec": spec,
        "voxel_generator": voxel_generator,
        "target_assigner": target_assigner,
        "box_coder": box_coder,
        "model_cfg": model_cfg,
        "dense_shape": dense_shape,
        "anchor_cache": anchor_cache,
        "out_size_factor": out_size_factor,
        "feature_map_size": feature_map_size,
    }


def make_anchor_cache(target_assigner, feature_map_size, grid_size):
    """Anchors generated once per run (host numpy, as the JAX package).
    Every example of the run ships ``anchors`` itself, not a copy, so
    it is read-only: a write in place raises instead of changing every
    later example."""
    ret = target_assigner.generate_anchors(feature_map_size)
    anchors = ret["anchors"].reshape([-1, target_assigner.box_ndim])
    anchors.setflags(write=False)
    return {
        "anchors": anchors,
        "anchors_bv": box_ops.rbbox2d_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]]),
        "matched_thresholds": ret["matched_thresholds"],
        "unmatched_thresholds": ret["unmatched_thresholds"],
        "anchors_dict": target_assigner.generate_anchors_dict(feature_map_size),
        "class_names": target_assigner.classes,
        "feature_map_size": list(feature_map_size),
        "grid_size": np.asarray(grid_size),
    }
