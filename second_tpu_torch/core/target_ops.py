"""Anchor <-> ground-truth matching (detectron-style).

Semantics pinned by reference second/core/target_ops.py:29-229
(create_target_np): argmax in both directions, force-matching ties for
each gt's best anchors, matched/unmatched thresholds, optional
positive-fraction subsampling, encode fg targets, unmap to the full
anchor set.
"""

import numpy as np


def unmap(data, count, inds, fill=0):
    """Scatter a subset back to an array of size ``count``."""
    if count == len(inds):
        return data
    ret = np.full((count,) + data.shape[1:], fill, dtype=data.dtype)
    ret[inds] = data
    return ret


def create_target_np(all_anchors,
                     gt_boxes,
                     similarity_fn,
                     box_encoding_fn,
                     prune_anchor_fn=None,
                     gt_classes=None,
                     matched_threshold=0.6,
                     unmatched_threshold=0.45,
                     positive_fraction=None,
                     rpn_batch_size=300,
                     norm_by_num_examples=False,
                     gt_importance=None,
                     box_code_size=7,
                     rng=None):
    """Assign classification labels and regression targets to anchors.

    Args:
        all_anchors: [num_anchors, box_ndim].
        gt_boxes: [num_gt, box_ndim].
        similarity_fn: (anchors, gt) -> [num_anchors, num_gt] similarity.
        box_encoding_fn: (gt, anchors) -> encodings.
        prune_anchor_fn: optional fn returning indices of anchors to keep.
        gt_classes: [num_gt] int labels starting at 1.
        matched_threshold / unmatched_threshold: scalar or per-anchor.
        positive_fraction: if set, subsample to pos/total ratio.
        rpn_batch_size: sample size for subsampling.
        gt_importance: [num_gt] per-gt loss weight.
        rng: numpy Generator for subsampling (defaults to np.random).

    Returns dict with labels (-1 ignore / 0 bg / class id), bbox_targets,
    bbox_outside_weights, importance, assigned anchor bookkeeping.
    """
    rng = rng or np.random
    total_anchors = all_anchors.shape[0]
    if prune_anchor_fn is not None:
        inds_inside = prune_anchor_fn(all_anchors)
        anchors = all_anchors[inds_inside, :]
        if not isinstance(matched_threshold, float):
            matched_threshold = matched_threshold[inds_inside]
        if not isinstance(unmatched_threshold, float):
            unmatched_threshold = unmatched_threshold[inds_inside]
    else:
        anchors = all_anchors
        inds_inside = None
    num_inside = len(inds_inside) if inds_inside is not None else total_anchors

    if gt_classes is None:
        gt_classes = np.ones([gt_boxes.shape[0]], dtype=np.int32)
    if gt_importance is None:
        gt_importance = np.ones([gt_boxes.shape[0]], dtype=np.float32)

    labels = np.full((num_inside,), -1, dtype=np.int32)
    gt_ids = np.full((num_inside,), -1, dtype=np.int32)
    importance = np.ones((num_inside,), dtype=np.float32)

    if len(gt_boxes) > 0 and num_inside > 0:
        overlap = similarity_fn(anchors, gt_boxes)  # [A, G]
        anchor_to_gt_argmax = overlap.argmax(axis=1)
        anchor_to_gt_max = overlap[np.arange(num_inside), anchor_to_gt_argmax]
        gt_to_anchor_argmax = overlap.argmax(axis=0)
        gt_to_anchor_max = overlap[gt_to_anchor_argmax, np.arange(overlap.shape[1])]
        # gts that match nothing must not force-match anchors at 0 overlap
        gt_to_anchor_max = np.where(gt_to_anchor_max == 0, -1, gt_to_anchor_max)
        # force matches: every anchor tied at a gt's best overlap
        anchors_with_max_overlap = np.where(overlap == gt_to_anchor_max)[0]
        gt_inds_force = anchor_to_gt_argmax[anchors_with_max_overlap]
        labels[anchors_with_max_overlap] = gt_classes[gt_inds_force]
        gt_ids[anchors_with_max_overlap] = gt_inds_force
        # threshold matches
        pos_inds = anchor_to_gt_max >= matched_threshold
        gt_inds = anchor_to_gt_argmax[pos_inds]
        labels[pos_inds] = gt_classes[gt_inds]
        gt_ids[pos_inds] = gt_inds
        bg_inds = np.where(anchor_to_gt_max < unmatched_threshold)[0]
        importance[pos_inds] = gt_importance[gt_inds]
    else:
        bg_inds = np.arange(num_inside)

    fg_inds = np.where(labels > 0)[0]
    fg_max_overlap = anchor_to_gt_max[fg_inds] if len(gt_boxes) > 0 and num_inside > 0 else None
    gt_pos_ids = gt_ids[fg_inds]

    if positive_fraction is not None:
        num_fg = int(positive_fraction * rpn_batch_size)
        if len(fg_inds) > num_fg:
            disable_inds = rng.choice(
                fg_inds, size=(len(fg_inds) - num_fg), replace=False)
            labels[disable_inds] = -1
            fg_inds = np.where(labels > 0)[0]
        num_bg = rpn_batch_size - np.sum(labels > 0)
        if len(bg_inds) > num_bg:
            draw = rng.integers if hasattr(rng, "integers") else rng.randint
            enable_inds = bg_inds[draw(len(bg_inds), size=num_bg)]
            labels[enable_inds] = 0
    else:
        if len(gt_boxes) == 0 or num_inside == 0:
            labels[:] = 0
        else:
            labels[bg_inds] = 0
            # force matches override background
            labels[anchors_with_max_overlap] = gt_classes[gt_inds_force]

    bbox_targets = np.zeros((num_inside, box_code_size), dtype=all_anchors.dtype)
    if len(gt_boxes) > 0 and num_inside > 0 and len(fg_inds) > 0:
        bbox_targets[fg_inds, :] = box_encoding_fn(
            gt_boxes[anchor_to_gt_argmax[fg_inds], :], anchors[fg_inds, :])

    bbox_outside_weights = np.zeros((num_inside,), dtype=all_anchors.dtype)
    if norm_by_num_examples:
        num_examples = max(1.0, np.sum(labels >= 0))
        bbox_outside_weights[labels > 0] = 1.0 / num_examples
    else:
        bbox_outside_weights[labels > 0] = 1.0

    if inds_inside is not None:
        labels = unmap(labels, total_anchors, inds_inside, fill=-1)
        bbox_targets = unmap(bbox_targets, total_anchors, inds_inside, fill=0)
        bbox_outside_weights = unmap(
            bbox_outside_weights, total_anchors, inds_inside, fill=0)
        importance = unmap(importance, total_anchors, inds_inside, fill=0)

    return {
        "labels": labels,
        "bbox_targets": bbox_targets,
        "bbox_outside_weights": bbox_outside_weights,
        "assigned_anchors_overlap": fg_max_overlap,
        "positive_gt_id": gt_pos_ids,
        "importance": importance,
        "assigned_anchors_inds": (
            inds_inside[fg_inds] if inds_inside is not None else fg_inds
        ),
    }
