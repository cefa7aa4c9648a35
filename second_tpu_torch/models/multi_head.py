"""The nuScenes multi-head detector (twin of
``second_tpu/models/multi_head.py``; reference
second/pytorch/models/net_multi_head.py).

Two heads over one ``RPNNoHead`` backbone: a small-object head (three
3x3 ConvBNReLU at 64 channels, then the 1x1 heads) on the stride-1
``stage0`` map cropped by ``round(0.1 * H)`` on each side, for
pedestrians, cones, bikes and barriers, and a head of 1x1 convs alone
on the upsampled ``out`` map, for cars, trucks, trailers, buses and
construction vehicles. The preds concatenate LARGE then SMALL, the
order of the config's ``class_settings`` and of its per-class anchors;
within a head they are anchor-type-major, as ``rpn.head_reshape`` lays
them out.

``rpn_preds`` applies both heads, so the flat pillar path
(``models.pp_fast``), which calls it on the BEV canvas, serves this
network as it serves RPNV2's. The JAX package's flat path calls the RPN
alone, which returns no preds for this network (``ROADMAP.md`` section
3).
"""

import numpy as np
import torch
from torch import nn

from ..utils import timer
from .layers import promoted
from .registry import register_voxelnet
from .rpn import ConvBNReLU, RPNNoHead, head_reshape
from .voxelnet import VoxelNet

SMALL_CLASSES = (
    "pedestrian", "traffic_cone", "bicycle", "motorcycle", "barrier")
LARGE_CLASSES = ("car", "truck", "trailer", "bus", "construction_vehicle")


class _Head(nn.Module):
    """``conv_stack`` ConvBNReLU(64, 3, 1) (``layers``), then the 1x1
    ``conv_box``, ``conv_cls`` and ``conv_dir_cls`` in f32 -> preds
    [B, nloc * H * W, size]. Its ConvBNReLUs always carry a batch norm:
    the JAX head passes them no ``use_norm``."""

    def __init__(self, cin, num_class, num_anchor_per_loc, box_code_size,
                 num_direction_bins, use_direction_classifier,
                 encode_background_as_zeros, conv_stack=0):
        super().__init__()
        self.num_anchor_per_loc = num_anchor_per_loc
        self.box_code_size = box_code_size
        self.num_direction_bins = num_direction_bins
        self.layers = nn.ModuleList()
        for _ in range(conv_stack):
            self.layers.append(ConvBNReLU(cin, 64, 3, 1))
            cin = 64
        nloc = num_anchor_per_loc
        cls_per_loc = (num_class if encode_background_as_zeros
                       else num_class + 1)
        self.conv_box = nn.Conv2d(cin, nloc * box_code_size, 1)
        self.conv_cls = nn.Conv2d(cin, nloc * cls_per_loc, 1)
        if use_direction_classifier:
            self.conv_dir_cls = nn.Conv2d(cin, nloc * num_direction_bins, 1)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        # flax's convs without a dtype compute in the promoted dtype of
        # a bf16 input and their f32 kernels
        x = promoted(x, torch.float32)
        nloc, b = self.num_anchor_per_loc, x.shape[0]

        def flat(preds, size):
            return head_reshape(preds, nloc, size).reshape(b, -1, size)

        cls = self.conv_cls(x)
        ret = {"box_preds": flat(self.conv_box(x), self.box_code_size),
               "cls_preds": flat(cls, cls.shape[1] // nloc)}
        if hasattr(self, "conv_dir_cls"):
            ret["dir_cls_preds"] = flat(self.conv_dir_cls(x),
                                        self.num_direction_bins)
        return ret


@register_voxelnet
class VoxelNetNuscenesMultiHead(VoxelNet):
    """The 10-class nuScenes network: ``VoxelNet`` with an ``RPNNoHead``
    backbone, ``small_head`` and ``large_head``.

    class_names: the target assigner's classes, in its order;
    num_anchor_per_loc_by_class: each class's anchors per location
    (``target_assigner.num_anchors_per_location_class``)."""

    def __init__(self, *args, class_names=(), num_anchor_per_loc_by_class=(),
                 **kwargs):
        super().__init__(*args, **kwargs)
        if self.num_class != 10:
            raise ValueError("the multi-head network expects 10 classes, "
                             f"not {self.num_class}")
        if not isinstance(self.rpn, RPNNoHead):
            raise ValueError("the multi-head network takes an RPNNoHead "
                             "backbone")
        nloc = dict(zip(class_names, num_anchor_per_loc_by_class))
        common = dict(
            num_class=self.num_class, box_code_size=self.box_code_size,
            num_direction_bins=self.num_direction_bins,
            use_direction_classifier=self.use_direction_classifier,
            encode_background_as_zeros=self.encode_background_as_zeros)
        rpn = self.rpn
        self.small_head = _Head(
            rpn.layers[0].conv.out_channels,
            num_anchor_per_loc=sum(nloc[c] for c in SMALL_CLASSES),
            conv_stack=3, **common)
        self.large_head = _Head(
            rpn.final_num_filters,
            num_anchor_per_loc=sum(nloc[c] for c in LARGE_CLASSES),
            **common)

    def rpn_preds(self, spatial):
        """The backbone on the BEV map [B, C, H, W], then both heads ->
        preds [B, A, ...], large then small. The heads (the crop, both
        heads, the concatenation) run in the span "net.heads" inside
        "net.rpn", so the profiler's innermost span gives the backbone
        to "net.rpn" and the heads to "net.heads"."""
        with timer.span("net.rpn"):
            rpn_out = self.rpn(spatial)
            with timer.span("net.heads"):
                r1 = rpn_out["stage0"]
                crop = int(np.round(r1.shape[2] * 0.1))
                r1 = r1[:, :, crop:-crop, crop:-crop]
                small = self.small_head(r1)
                large = self.large_head(rpn_out["out"])
                return {k: torch.cat([large[k], small[k]], dim=1)
                        for k in large}
