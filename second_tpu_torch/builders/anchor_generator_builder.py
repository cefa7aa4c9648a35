"""Anchor generator from a ClassSetting (reference
second/builder/anchor_generator_builder.py:8-48).

The port's copy of ``second_tpu/builders/anchor_generator_builder.py``."""

import numpy as np

from ..configs import schema
from ..core.anchor_generator import AnchorGeneratorRange, AnchorGeneratorStride


def build(class_cfg: schema.ClassSetting):
    which = class_cfg.WhichOneof("anchor_generator")
    if which == "anchor_generator_stride":
        cfg = class_cfg.anchor_generator_stride
        return AnchorGeneratorStride(
            sizes=list(cfg.sizes),
            anchor_strides=list(cfg.strides),
            anchor_offsets=list(cfg.offsets),
            rotations=list(cfg.rotations),
            match_threshold=class_cfg.matched_threshold,
            unmatch_threshold=class_cfg.unmatched_threshold,
            class_name=class_cfg.class_name,
            custom_values=list(cfg.custom_values),
            dtype=np.float32,
        )
    if which == "anchor_generator_range":
        cfg = class_cfg.anchor_generator_range
        return AnchorGeneratorRange(
            sizes=list(cfg.sizes),
            anchor_ranges=list(cfg.anchor_ranges),
            rotations=list(cfg.rotations),
            match_threshold=class_cfg.matched_threshold,
            unmatch_threshold=class_cfg.unmatched_threshold,
            class_name=class_cfg.class_name,
            custom_values=list(cfg.custom_values),
            dtype=np.float32,
        )
    if which == "no_anchor":
        return None
    raise ValueError("unknown anchor generator type")
