"""VoxelNet: VFE + middle (sparse or dense) + RPN, plus the loss and the
predict post-process (twin of ``second_tpu/models/voxelnet.py``).

``VoxelNet`` is the network forward, voxels -> preds [B, A, ...];
``ModelSpec`` holds the loss and post-process settings built once from
the config; :func:`compute_loss` is the training loss;
:func:`predict` turns preds into fixed-size detections with a validity
mask, on the device, through the NMS of ``ops.nms``.
"""

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import box_ops_torch
from ..ops import losses as L
from ..ops.nms import nms_bev
from ..utils import timer
from .layers import MaskedBatchNorm
from .sparse_middle import SparseMiddleBase
from .registry import (
    get_middle_class,
    get_rpn_class,
    get_vfe_class,
    register_voxelnet,
)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static loss and post-process configuration (the JAX
    ``ModelSpec``)."""

    num_class: int
    box_code_size: int
    num_anchor_per_loc: int
    # loss
    cls_loss_fn: Callable = None
    loc_loss_fn: Callable = None
    dir_loss_fn: Callable = None
    cls_loss_weight: float = 1.0
    loc_loss_weight: float = 2.0
    direction_loss_weight: float = 0.2
    pos_cls_weight: float = 1.0
    neg_cls_weight: float = 1.0
    loss_norm_type: int = L.NORM_BY_NUM_POSITIVES
    encode_rad_error_by_sin: bool = True
    sin_error_factor: float = 1.0
    # box coder, nms and post-process
    encode_background_as_zeros: bool = True
    use_sigmoid_score: bool = True
    use_direction_classifier: bool = True
    num_direction_bins: int = 2
    dir_offset: float = 0.0
    dir_limit_offset: float = 0.0
    linear_dim: bool = False
    vec_encode: bool = False
    bev_coder: bool = False
    bev_z_fixed: float = -1.0
    bev_h_fixed: float = 2.0
    use_rotate_nms: bool = True
    multiclass_nms: bool = False
    nms_class_agnostic: bool = False
    nms_score_thresholds: Tuple[float, ...] = (0.05,)
    nms_pre_max_sizes: Tuple[int, ...] = (1000,)
    nms_post_max_sizes: Tuple[int, ...] = (100,)
    nms_iou_thresholds: Tuple[float, ...] = (0.5,)
    post_center_range: Tuple[float, ...] = ()
    # per-class anchor index ranges [start, end) for multi-class NMS
    anchors_ranges: Tuple[Tuple[int, int], ...] = ()

    def decode(self, encodings, anchors):
        if self.bev_coder:
            # (x, y, w, l, r) of the anchors by slices (no host index)
            bev = torch.cat([anchors[..., 0:2], anchors[..., 3:5],
                             anchors[..., 6:7]], dim=-1)
            ret = box_ops_torch.bev_box_decode(
                encodings, bev, self.vec_encode, self.linear_dim)
            z = torch.full_like(ret[..., :1], self.bev_z_fixed)
            h = torch.full_like(ret[..., :1], self.bev_h_fixed)
            return torch.cat(
                [ret[..., :2], z, ret[..., 2:4], h, ret[..., 4:]], dim=-1)
        return box_ops_torch.second_box_decode(
            encodings, anchors, self.vec_encode, self.linear_dim)


def _torch_dtype(name):
    """A compute dtype's name -> the torch dtype (None stays None: f32)."""
    if name is None:
        return None
    if name != "bfloat16":
        raise ValueError(f"compute_dtype must be None or 'bfloat16', not "
                         f"{name!r}: the port's kernels take f32 and bf16")
    return torch.bfloat16


@register_voxelnet
class VoxelNet(nn.Module):
    """voxels -> {box_preds, cls_preds, dir_cls_preds}, each [B, A, .]."""

    def __init__(self, output_shape, num_class=1, num_input_features=4,
                 vfe_class_name="SimpleVoxel", vfe_num_filters=(32, 128),
                 with_distance=False, middle_class_name="SpMiddleFHD",
                 middle_num_input_features=-1, middle_num_filters_d1=(64,),
                 middle_num_filters_d2=(64, 64), rpn_class_name="RPNV2",
                 rpn_num_input_features=-1, rpn_layer_nums=(3, 5, 5),
                 rpn_layer_strides=(2, 2, 2), rpn_num_filters=(128, 128, 256),
                 rpn_upsample_strides=(1, 2, 4),
                 rpn_num_upsample_filters=(256, 256, 256),
                 use_groupnorm=False, num_groups=32,
                 use_direction_classifier=True,
                 encode_background_as_zeros=True, num_direction_bins=2,
                 num_anchor_per_loc=2, box_code_size=7,
                 voxel_size=(0.2, 0.2, 4), pc_range=(0, -40, -3, 70.4, 40, 1),
                 use_norm=True, compute_dtype=None):
        """compute_dtype: None (f32) or "bfloat16", the JAX package's
        mixed precision: the sparse middle and the RPN run in bf16 (see
        their modules), the encoder, a dense middle's scatter, the heads
        and everything after them in f32; parameters stay f32.
        use_norm=False: the encoder's, the middle's and the RPN's layers
        carry biases and no normalisation (``build_network`` sets True,
        as the JAX package's does)."""
        super().__init__()
        self.num_class = num_class
        self.box_code_size = box_code_size
        self.num_direction_bins = num_direction_bins
        self.use_direction_classifier = use_direction_classifier
        self.encode_background_as_zeros = encode_background_as_zeros
        self.compute_dtype = _torch_dtype(compute_dtype)
        self.voxel_feature_extractor = get_vfe_class(vfe_class_name)(
            num_input_features=num_input_features,
            num_filters=tuple(vfe_num_filters), with_distance=with_distance,
            voxel_size=tuple(voxel_size), pc_range=tuple(pc_range),
            use_norm=use_norm)
        middle_cls = get_middle_class(middle_class_name)
        # a dense middle's scatter is dtype-agnostic (JAX's takes the
        # field and ignores it)
        middle_dtype = ({"compute_dtype": self.compute_dtype}
                        if issubclass(middle_cls, SparseMiddleBase) else {})
        self.middle_feature_extractor = middle_cls(
            output_shape=tuple(output_shape),
            num_input_features=middle_num_input_features,
            num_filters_down1=tuple(middle_num_filters_d1),
            num_filters_down2=tuple(middle_num_filters_d2),
            use_norm=use_norm, **middle_dtype)
        self.rpn = get_rpn_class(rpn_class_name)(
            num_class=num_class,
            layer_nums=tuple(rpn_layer_nums),
            layer_strides=tuple(rpn_layer_strides),
            num_filters=tuple(rpn_num_filters),
            upsample_strides=tuple(rpn_upsample_strides),
            num_upsample_filters=tuple(rpn_num_upsample_filters),
            num_input_features=rpn_num_input_features,
            num_anchor_per_loc=num_anchor_per_loc,
            encode_background_as_zeros=encode_background_as_zeros,
            use_direction_classifier=use_direction_classifier,
            use_groupnorm=use_groupnorm, num_groups=num_groups,
            box_code_size=box_code_size,
            num_direction_bins=num_direction_bins,
            compute_dtype=self.compute_dtype, use_norm=use_norm)

    def forward(self, voxels, num_points, coords, sparse_plan=None,
                intermediates=None):
        """voxels [B, V, T, F], num_points [B, V], coords [B, V, 3] zyx.

        For a sparse middle, sparse_plan is the host plan (see
        ``sparse_middle.build_host_plan``) batched on the device, with
        the voxels sorted by linear id; without one (None or empty) the
        middle builds its rulebooks on the device and puts its stages'
        counts into the dict ``intermediates``, when one is given. A
        dense middle takes neither."""
        with timer.span("net.encode"):
            voxel_features = self.voxel_feature_extractor(
                voxels, num_points, coords)
        middle = self.middle_feature_extractor
        with timer.span("net.middle"):
            if isinstance(middle, SparseMiddleBase):
                spatial = middle(voxel_features, coords, sparse_plan,
                                 intermediates)
            else:
                spatial = middle(voxel_features, coords)
        return self.rpn_preds(spatial)

    def rpn_preds(self, spatial):
        """The RPN on the BEV map [B, C, H, W] -> preds [B, A, ...]."""
        with timer.span("net.rpn"):
            preds = self.rpn(spatial)
            b = spatial.shape[0]
            cls_size = (self.num_class if self.encode_background_as_zeros
                        else self.num_class + 1)
            out = {
                "box_preds": preds["box_preds"].reshape(
                    b, -1, self.box_code_size),
                "cls_preds": preds["cls_preds"].reshape(b, -1, cls_size),
            }
            if self.use_direction_classifier:
                out["dir_cls_preds"] = preds["dir_cls_preds"].reshape(
                    b, -1, self.num_direction_bins)
            return out


@torch.no_grad()
def init_weights(net, generator):
    """Random weights from ``generator`` (a CPU ``torch.Generator``),
    distributed as the JAX package initialises them: sparse conv
    weights [K, Cin, Cout] normal with variance 1/(K*Cin), dense convs
    and linear layers LeCun truncated normal, biases zero, batch norm at
    identity."""

    def draw(shape, std, truncated):
        t = torch.empty(shape)
        if truncated:
            # lecun_normal: truncated at 2 std, rescaled to unit variance
            std = std / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        else:
            nn.init.normal_(t, 0.0, std, generator=generator)
        return t

    for module in net.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if isinstance(module, nn.Linear):
                fan_in = module.in_features
            else:
                ks = module.kernel_size
                fan_in = module.in_channels * ks[0] * ks[1]
            module.weight.copy_(
                draw(module.weight.shape, fan_in ** -0.5, True))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, MaskedBatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    for name, p in net.named_parameters():
        if name.endswith("_w"):  # sparse middle [K, Cin, Cout]
            p.copy_(draw(p.shape, (p.shape[0] * p.shape[1]) ** -0.5, False))
        elif name.endswith("_b"):  # its biases without a norm
            p.zero_()


def compute_loss(spec: ModelSpec, preds: Dict[str, torch.Tensor],
                 example: Dict[str, torch.Tensor]):
    """The training loss (reference voxelnet.py:239-312 + 704-830):
    preds [B, A, ...] and the example's labels [B, A], reg_targets
    [B, A, code], anchors and optional importance -> dict of scalars."""
    box_preds = preds["box_preds"]
    cls_preds = preds["cls_preds"]
    batch_size = box_preds.shape[0]
    labels = example["labels"]
    reg_targets = example["reg_targets"]
    importance = example.get("importance")
    if importance is None:
        importance = torch.ones_like(labels, dtype=box_preds.dtype)

    cls_weights, reg_weights, cared = L.prepare_loss_weights(
        labels, pos_cls_weight=spec.pos_cls_weight,
        neg_cls_weight=spec.neg_cls_weight,
        loss_norm_type=spec.loss_norm_type, dtype=box_preds.dtype)
    cls_targets = (labels * cared.to(labels.dtype)).long()
    one_hot = F.one_hot(cls_targets, spec.num_class + 1).to(box_preds.dtype)
    if spec.encode_background_as_zeros:
        one_hot = one_hot[..., 1:]
    bp, rt = box_preds, reg_targets
    if spec.encode_rad_error_by_sin:
        bp, rt = L.add_sin_difference(bp, rt, spec.sin_error_factor)
    loc_losses = spec.loc_loss_fn(bp, rt, weights=reg_weights * importance)
    cls_losses = spec.cls_loss_fn(
        cls_preds, one_hot, weights=cls_weights * importance)

    loc_loss_reduced = loc_losses.sum() / batch_size * spec.loc_loss_weight
    cls_loss_sum = cls_losses.sum(dim=-1)  # [B, A]
    cls_pos = (cls_loss_sum * (labels > 0)).sum() / batch_size
    cls_neg = (cls_loss_sum * (labels == 0)).sum() / batch_size
    cls_loss_reduced = cls_losses.sum() / batch_size * spec.cls_loss_weight
    loss = loc_loss_reduced + cls_loss_reduced

    res = {
        "loss": loss,
        "cls_loss_reduced": cls_loss_reduced,
        "loc_loss_reduced": loc_loss_reduced,
        "cls_pos_loss": cls_pos / spec.pos_cls_weight,
        "cls_neg_loss": cls_neg / spec.neg_cls_weight,
        "cared": cared,
        "cls_preds": cls_preds,
    }
    if spec.use_direction_classifier:
        dir_targets = L.get_direction_target(
            example["anchors"], reg_targets, dir_offset=spec.dir_offset,
            num_bins=spec.num_direction_bins, dtype=box_preds.dtype)
        weights = (labels > 0).to(box_preds.dtype) * importance
        weights = weights / weights.sum(-1, keepdim=True).clamp(min=1.0)
        dir_loss = spec.dir_loss_fn(preds["dir_cls_preds"], dir_targets,
                                    weights=weights)
        dir_loss = dir_loss.sum() / batch_size
        res["dir_loss_reduced"] = dir_loss
        res["loss"] = loss + dir_loss * spec.direction_loss_weight
    return res


def _single_frame_predict(spec: ModelSpec, box_preds, cls_preds, dir_preds,
                          anchors, anchors_mask):
    """One frame: [A, code], [A, C], [A, bins], [A, 7+] -> fixed-size
    detections."""
    box_preds = spec.decode(box_preds, anchors)
    if spec.encode_background_as_zeros:
        total_scores = torch.sigmoid(cls_preds)
    elif spec.use_sigmoid_score:
        total_scores = torch.sigmoid(cls_preds)[..., 1:]
    else:
        total_scores = torch.softmax(cls_preds, dim=-1)[..., 1:]
    if dir_preds is not None:
        dir_labels = torch.argmax(dir_preds, dim=-1)
    else:
        dir_labels = torch.zeros(box_preds.shape[0], dtype=torch.long,
                                 device=box_preds.device)
    if anchors_mask is not None:
        total_scores = torch.where(
            anchors_mask[:, None], total_scores,
            torch.full_like(total_scores, -math.inf))
    # (x, y, w, l, r) by slices: a list index would copy from the host,
    # which a CUDA graph cannot capture
    bev_boxes = torch.cat(
        [box_preds[:, 0:2], box_preds[:, 3:5], box_preds[:, 6:7]], dim=-1)
    if spec.multiclass_nms:
        # one NMS per class over that class's anchors (all of them when
        # class-agnostic), each with the class's own sizes and
        # thresholds; the ranges are static, so each slice is a view
        outs = []
        for ci in range(spec.num_class):
            s, e = ((0, box_preds.shape[0]) if spec.nms_class_agnostic
                    else spec.anchors_ranges[ci])
            cls_scores = total_scores[s:e, ci]
            idx, valid = nms_bev(
                bev_boxes[s:e], cls_scores,
                pre_max_size=spec.nms_pre_max_sizes[ci],
                post_max_size=spec.nms_post_max_sizes[ci],
                iou_threshold=spec.nms_iou_thresholds[ci],
                score_threshold=spec.nms_score_thresholds[ci],
                rotated=spec.use_rotate_nms)
            gi = idx.clamp(min=0)
            outs.append((box_preds[s:e][gi],
                         torch.where(valid, cls_scores[gi], 0.0),
                         torch.full_like(idx, ci), dir_labels[s:e][gi],
                         valid))
        boxes, scores, labels, dirs, valid = (
            torch.cat(parts) for parts in zip(*outs))
    else:
        if total_scores.shape[-1] == 1:
            top_scores = total_scores[..., 0]
            top_labels = torch.zeros(box_preds.shape[0], dtype=torch.long,
                                     device=box_preds.device)
        else:
            top_scores, top_labels = torch.max(total_scores, dim=-1)
        idx, valid = nms_bev(
            bev_boxes, top_scores,
            pre_max_size=spec.nms_pre_max_sizes[0],
            post_max_size=spec.nms_post_max_sizes[0],
            iou_threshold=spec.nms_iou_thresholds[0],
            score_threshold=spec.nms_score_thresholds[0],
            rotated=spec.use_rotate_nms)
        gi = idx.clamp(min=0)
        boxes = box_preds[gi]
        scores = torch.where(valid, top_scores[gi], 0.0)
        labels = top_labels[gi]
        dirs = dir_labels[gi]
    if spec.use_direction_classifier:
        # yaw from the direction bin with the config's limit offset,
        # exactly as the JAX package (and the reference) reconstruct it
        period = 2 * math.pi / spec.num_direction_bins
        dir_rot = box_ops_torch.limit_period(
            boxes[..., 6] - spec.dir_offset, spec.dir_limit_offset, period)
        yaw = dir_rot + spec.dir_offset + period * dirs.to(boxes.dtype)
        boxes = torch.cat([boxes[..., :6], yaw[..., None], boxes[..., 7:]],
                          dim=-1)
    if len(spec.post_center_range) > 0:
        lo, hi = spec.post_center_range[:3], spec.post_center_range[3:]
        for i in range(3):
            valid = valid & (boxes[:, i] >= lo[i]) & (boxes[:, i] <= hi[i])
    return {
        "box3d_lidar": boxes,
        "scores": torch.where(valid, scores, 0.0),
        "label_preds": labels,
        "valid": valid,
    }


def predict(spec: ModelSpec, preds: Dict[str, torch.Tensor],
            example: Dict[str, torch.Tensor]):
    """Batched fixed-size detections: a dict of [B, Nout, ...] tensors
    with a ``valid`` mask."""
    with timer.span("net.predict"):
        anchors = example["anchors"]
        anchors_mask = example.get("anchors_mask")
        dir_preds = preds.get("dir_cls_preds")
        frames = [
            _single_frame_predict(
                spec, preds["box_preds"][b], preds["cls_preds"][b],
                None if dir_preds is None else dir_preds[b], anchors[b],
                None if anchors_mask is None else anchors_mask[b])
            for b in range(anchors.shape[0])
        ]
        return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
