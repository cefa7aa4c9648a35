"""Fixed-size BEV NMS on the device (twin of ``second_tpu/ops/nms.py``).

top-k -> score gate -> pairwise IoU (K3 for rotated boxes) -> greedy
sweep (K4) -> the first ``post_max_size`` kept candidates, -1 padded.
No step synchronises with the host.
"""

import torch

from . import box_ops_torch, cuda_iou, cuda_nms


def _standup_iou(boxes_standup):
    """Pairwise IoU of [N, 4] xyxy boxes (eps=0 convention)."""
    b = boxes_standup
    iw = (torch.minimum(b[:, None, 2], b[None, :, 2])
          - torch.maximum(b[:, None, 0], b[None, :, 0]))
    ih = (torch.minimum(b[:, None, 3], b[None, :, 3])
          - torch.maximum(b[:, None, 1], b[None, :, 1]))
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area[:, None] + area[None, :] - inter
    return inter / torch.where(union <= 0, torch.ones_like(union), union)


def candidate_iou(boxes, rotated):
    """Pairwise BEV IoU of [n, 5] boxes (x, y, w, l, r): of the rotated
    boxes (K3), or of their axis-aligned standup boxes."""
    if rotated:
        return cuda_iou.rotated_iou_matrix(boxes, boxes)
    corners = box_ops_torch.box_to_corners(boxes)
    return _standup_iou(box_ops_torch.corner_to_standup(corners))


def nms_bev(boxes, scores, pre_max_size, post_max_size, iou_threshold,
            score_threshold=0.0, rotated=True):
    """boxes [A, 5] (x, y, w, l, r), scores [A] (-inf = masked anchor).

    Returns indices [post_max_size] int64 into A (-1 padding) and
    valid [post_max_size] bool, as ``second_tpu.ops.nms.nms_bev``.
    """
    k = min(pre_max_size, boxes.shape[0])
    # ties go to the lower index, as jax.lax.top_k orders them (torch.topk
    # leaves tie order to the device); a random-weight network scores
    # every empty BEV cell alike, so ties are common
    top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    if score_threshold > 0.0:
        cand_valid = top_scores >= score_threshold
    else:
        cand_valid = top_scores > -float("inf")
    iou = candidate_iou(boxes[top_idx].contiguous(), rotated)
    keep = cuda_nms.greedy_suppress(iou, cand_valid, iou_threshold)
    # ranks of the kept candidates in order, k (= none) after them:
    # nonzero(size=post_max_size) without a host sync
    rank = torch.arange(k, device=boxes.device)
    order = torch.where(keep, rank, torch.full_like(rank, k))
    sel = torch.sort(order).values[:post_max_size]
    if sel.shape[0] < post_max_size:
        sel = torch.cat([sel, sel.new_full((post_max_size - sel.shape[0],), k)])
    sel_valid = sel < k
    indices = torch.where(sel_valid, top_idx[sel.clamp(max=max(k - 1, 0))],
                          torch.full_like(sel, -1))
    return indices, sel_valid
