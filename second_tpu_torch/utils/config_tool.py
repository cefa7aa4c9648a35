"""Config helpers (reference second/utils/config_tool/__init__.py); the
port copies only what it calls."""

import numpy as np

from ..configs import schema


def get_downsample_factor(model_config: schema.VoxelNet) -> int:
    downsample_factor = np.prod(model_config.rpn.layer_strides)
    if len(model_config.rpn.upsample_strides) > 0:
        downsample_factor /= model_config.rpn.upsample_strides[-1]
    downsample_factor *= model_config.middle_feature_extractor.downsample_factor
    downsample_factor = int(np.round(downsample_factor))
    assert downsample_factor > 0
    return downsample_factor

