"""Anchor generators (reference: second/core/anchor_generator.py)."""

import numpy as np

from . import box_ops


class _AnchorGeneratorBase:
    def __init__(self, sizes, rotations, class_name, match_threshold,
                 unmatch_threshold, custom_values, dtype):
        self._sizes = sizes
        self._rotations = rotations
        self._class_name = class_name
        self.match_threshold = match_threshold
        self.unmatch_threshold = unmatch_threshold
        self._custom_values = tuple(custom_values)
        self._dtype = dtype

    @property
    def class_name(self):
        return self._class_name

    @property
    def num_anchors_per_localization(self):
        num_size = np.asarray(self._sizes).reshape([-1, 3]).shape[0]
        return len(self._rotations) * num_size

    @property
    def ndim(self):
        return 7 + len(self._custom_values)

    @property
    def custom_ndim(self):
        return len(self._custom_values)

    def _append_custom(self, res):
        if not self._custom_values:
            return res
        custom = np.broadcast_to(
            np.asarray(self._custom_values, dtype=res.dtype),
            (*res.shape[:-1], len(self._custom_values)),
        )
        return np.concatenate([res, custom], axis=-1)


class AnchorGeneratorStride(_AnchorGeneratorBase):
    def __init__(self,
                 sizes=(1.6, 3.9, 1.56),
                 anchor_strides=(0.4, 0.4, 1.0),
                 anchor_offsets=(0.2, -39.8, -1.78),
                 rotations=(0, np.pi / 2),
                 class_name=None,
                 match_threshold=-1,
                 unmatch_threshold=-1,
                 custom_values=(),
                 dtype=np.float32):
        super().__init__(sizes, rotations, class_name, match_threshold,
                         unmatch_threshold, custom_values, dtype)
        self._anchor_strides = anchor_strides
        self._anchor_offsets = anchor_offsets

    def generate(self, feature_map_size):
        res = box_ops.create_anchors_3d_stride(
            feature_map_size, self._sizes, self._anchor_strides,
            self._anchor_offsets, self._rotations, self._dtype)
        return self._append_custom(res)


class AnchorGeneratorRange(_AnchorGeneratorBase):
    def __init__(self,
                 anchor_ranges,
                 sizes=(1.6, 3.9, 1.56),
                 rotations=(0, np.pi / 2),
                 class_name=None,
                 match_threshold=-1,
                 unmatch_threshold=-1,
                 custom_values=(),
                 dtype=np.float32):
        super().__init__(sizes, rotations, class_name, match_threshold,
                         unmatch_threshold, custom_values, dtype)
        self._anchor_ranges = anchor_ranges

    def generate(self, feature_map_size):
        res = box_ops.create_anchors_3d_range(
            feature_map_size, self._anchor_ranges, self._sizes,
            self._rotations, self._dtype)
        return self._append_custom(res)
