"""Training metrics (twin of ``second_tpu/utils/metrics.py``
``classification_metrics``; reference torchplus/metrics.py:7-281 +
VoxelNet.update_metrics, voxelnet.py:654-686)."""

import torch

DEFAULT_THRESHOLDS = (0.1, 0.3, 0.5, 0.7, 0.8, 0.9, 0.95)


def classification_metrics(cls_preds, labels, thresholds=DEFAULT_THRESHOLDS,
                           encode_background_as_zeros=True):
    """Per-batch stats. cls_preds [B, A, C] logits, labels [B, A].

    Returns a dict of tensors on the device: TP/FP/FN counts at each
    score threshold over the cared anchors, and accuracy counts.
    """
    cared = labels >= 0
    if encode_background_as_zeros:
        scores = torch.reciprocal(1 + torch.exp(-cls_preds)).max(dim=-1).values
        pred_labels = cls_preds.argmax(dim=-1) + 1
    else:
        probs = torch.softmax(cls_preds, dim=-1)
        scores = 1.0 - probs[..., 0]
        pred_labels = cls_preds.argmax(dim=-1)
    positives = labels > 0
    th = torch.tensor(thresholds, dtype=scores.dtype, device=scores.device)
    score_pos = scores[None] >= th[:, None, None]  # [T, B, A]
    actual_pos = (positives & cared)[None]
    pred_pos = score_pos & cared[None]
    # accuracy at threshold 0.5-equivalent: predicted fg label correct
    pred_cls = torch.where(scores >= 0.5, pred_labels,
                           torch.zeros_like(pred_labels))
    return {
        "prec_tp": (pred_pos & actual_pos).sum(dim=(1, 2)),
        "prec_fp": (pred_pos & ~actual_pos).sum(dim=(1, 2)),
        "prec_fn": (~pred_pos & actual_pos).sum(dim=(1, 2)),
        "acc_correct": ((pred_cls == labels) & cared).sum(),
        "acc_total": cared.sum().clamp(min=1),
    }
