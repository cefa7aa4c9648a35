"""Region similarity calculators for anchor<->gt matching.

Reference: second/core/region_similarity.py. Inputs are BEV rotated
boxes [N, 5] (x, y, w, l, r); output is an [N, M] similarity matrix.
"""

from . import box_ops, rotated_iou


class RotateIouSimilarity:
    """Exact rotated-box IoU (standup-gated)."""

    def compare(self, boxes1, boxes2):
        return rotated_iou.rotated_iou(boxes1, boxes2)


class NearestIouSimilarity:
    """Axis-aligned IoU of the nearest 'standing/lying' boxes."""

    def compare(self, boxes1, boxes2):
        boxes1_bv = box_ops.rbbox2d_to_near_bbox(boxes1)
        boxes2_bv = box_ops.rbbox2d_to_near_bbox(boxes2)
        return box_ops.iou(boxes1_bv, boxes2_bv, eps=0.0)


class DistanceSimilarity:
    """Windowed negated center distance (optionally rotation-aware)."""

    def __init__(self, distance_norm, with_rotation=False, rotation_alpha=0.5):
        self._distance_norm = distance_norm
        self._with_rotation = with_rotation
        self._rotation_alpha = rotation_alpha

    def compare(self, boxes1, boxes2):
        return box_ops.distance_similarity(
            boxes1[..., [0, 1, -1]],
            boxes2[..., [0, 1, -1]],
            dist_norm=self._distance_norm,
            with_rotation=self._with_rotation,
            rot_alpha=self._rotation_alpha,
        )
