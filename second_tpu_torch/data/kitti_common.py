"""The parts of ``second_tpu/data/kitti_common.py`` that preprocessing
calls: select annotation rows by class name."""

import numpy as np


def keep_arrays_by_name(gt_names, used_classes):
    return np.array(
        [i for i, x in enumerate(gt_names) if x in used_classes],
        dtype=np.int64)


def drop_arrays_by_name(gt_names, used_classes):
    return np.array(
        [i for i, x in enumerate(gt_names) if x not in used_classes],
        dtype=np.int64)
