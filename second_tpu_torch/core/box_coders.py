"""Box coders (host/numpy side).

Mirrors the reference API surface (second/core/box_coders.py): a coder
exposes ``code_size``, ``encode(boxes, anchors)``, ``decode(encodings,
anchors)``.  The device twins live in
``second_tpu_torch.ops.box_ops_torch`` and share these exact formulas.
"""

import numpy as np

from . import box_ops


class GroundBox3dCoder:
    """Full 7(+custom)-DoF residual coder (reference box_coders.py:30-46)."""

    def __init__(self, linear_dim=False, vec_encode=False, custom_ndim=0):
        self.linear_dim = linear_dim
        self.vec_encode = vec_encode
        self.custom_ndim = custom_ndim

    @property
    def code_size(self):
        return self.custom_ndim + (8 if self.vec_encode else 7)

    def encode(self, boxes, anchors):
        return box_ops.second_box_encode(
            boxes, anchors, self.vec_encode, self.linear_dim
        )

    def decode(self, encodings, anchors):
        return box_ops.second_box_decode(
            encodings, anchors, self.vec_encode, self.linear_dim
        )


class BevBoxCoder:
    """BEV-only coder with fixed z/h (reference box_coders.py:49-77).

    Takes size-7 boxes/anchors, returns size-5/6 encodings.
    """

    def __init__(self, linear_dim=False, vec_encode=False, z_fixed=-1.0, h_fixed=2.0, custom_ndim=0):
        assert custom_ndim == 0
        self.linear_dim = linear_dim
        self.vec_encode = vec_encode
        self.z_fixed = z_fixed
        self.h_fixed = h_fixed
        self.custom_ndim = custom_ndim

    @property
    def code_size(self):
        return 6 if self.vec_encode else 5

    def encode(self, boxes, anchors):
        return box_ops.bev_box_encode(
            boxes[..., [0, 1, 3, 4, 6]],
            anchors[..., [0, 1, 3, 4, 6]],
            self.vec_encode,
            self.linear_dim,
        )

    def decode(self, encodings, anchors):
        ret = box_ops.bev_box_decode(
            encodings, anchors[..., [0, 1, 3, 4, 6]], self.vec_encode, self.linear_dim
        )
        z_fixed = np.full([*ret.shape[:-1], 1], self.z_fixed, dtype=ret.dtype)
        h_fixed = np.full([*ret.shape[:-1], 1], self.h_fixed, dtype=ret.dtype)
        return np.concatenate(
            [ret[..., :2], z_fixed, ret[..., 2:4], h_fixed, ret[..., 4:]], axis=-1
        )
