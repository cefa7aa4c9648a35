"""Loss functions (twin of ``second_tpu/ops/losses.py``).

Formula parity with the reference loss zoo
(second/pytorch/core/losses.py): TF-compatible elementwise sigmoid CE,
sigmoid/softmax focal losses, weighted smooth-L1 with sigma +
per-dimension code weights, weighted softmax (direction head), the GHM
losses, and the loss-weight preparation / sin-difference machinery from
second/pytorch/models/voxelnet.py:704-830.

All functions take [B, A, ...] and return per-anchor losses; reduction
happens in the model's loss assembly.
"""

import math

import functools

import torch
import torch.nn.functional as F

from ..parallel import mesh


def sigmoid_cross_entropy_with_logits(logits, labels):
    """Elementwise TF-style stable sigmoid CE."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def softmax_cross_entropy_with_logits(logits, labels_onehot):
    """CE against the argmax of a one-hot target (reference parity)."""
    log_probs = F.log_softmax(logits, dim=-1)
    hard = labels_onehot.argmax(dim=-1)
    return -torch.gather(log_probs, -1, hard[..., None])[..., 0]


@functools.lru_cache(maxsize=None)
def _code_weight_tensor(code_weights, dtype, device):
    """The code weights on ``device``, copied there once: a copy from
    the host on every call would synchronise the train step."""
    return torch.tensor(code_weights, dtype=dtype,
                        device=device).reshape(1, 1, -1)


def _code_weighted(diff, code_weights):
    if code_weights is None:
        return diff
    return _code_weight_tensor(tuple(code_weights), diff.dtype,
                               diff.device) * diff


def weighted_smooth_l1_loss(preds, targets, weights=None, sigma=3.0,
                            code_weights=None, codewise=True):
    """[B, A, C] -> [B, A, C] (codewise) or [B, A]."""
    abs_diff = _code_weighted(preds - targets, code_weights).abs()
    thresh = 1.0 / (sigma ** 2)
    loss = torch.where(abs_diff <= thresh,
                       0.5 * torch.square(abs_diff * sigma),
                       abs_diff - 0.5 * thresh)
    if codewise:
        if weights is not None:
            loss = loss * weights[..., None]
        return loss
    loss = loss.sum(dim=-1)
    if weights is not None:
        loss = loss * weights
    return loss


def weighted_l2_loss(preds, targets, weights=None, code_weights=None):
    diff = _code_weighted(preds - targets, code_weights)
    if weights is not None:
        diff = diff * weights[..., None]
    return (0.5 * diff * diff).sum(dim=-1)


def sigmoid_focal_loss(preds, targets_onehot, weights=None, gamma=2.0,
                       alpha=0.25):
    """[B, A, C] logits + one-hot targets -> [B, A, C] losses."""
    ce = sigmoid_cross_entropy_with_logits(preds, targets_onehot)
    probs = torch.sigmoid(preds)
    p_t = targets_onehot * probs + (1 - targets_onehot) * (1 - probs)
    mod = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    if alpha is not None:
        alpha_w = targets_onehot * alpha + (1 - targets_onehot) * (1 - alpha)
    else:
        alpha_w = 1.0
    loss = mod * alpha_w * ce
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def softmax_focal_loss(preds, targets_onehot, weights=None, gamma=2.0,
                       alpha=0.25):
    per_row_ce = softmax_cross_entropy_with_logits(preds, targets_onehot)
    probs = torch.softmax(preds, dim=-1)
    p_t = (targets_onehot * probs).sum(dim=-1)
    mod = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = 1.0
    if alpha is not None:
        # alpha on foreground rows (non-background argmax), reference parity
        is_fg = targets_onehot.argmax(dim=-1) >= 1
        alpha_w = torch.where(is_fg, alpha, 1 - alpha)
    loss = mod * alpha_w * per_row_ce
    if weights is not None:
        loss = loss * weights
    return loss


def bootstrapped_sigmoid_loss(preds, targets_onehot, weights=None,
                              alpha=0.5, hard_bootstrap=False):
    """Bootstrapped sigmoid CE (Reed et al. 2015; reference
    losses.py:395-452): targets are a convex mix of labels and the
    model's own (hard or soft) predictions."""
    probs = torch.sigmoid(preds)
    boot = (probs > 0.5).to(preds.dtype) if hard_bootstrap else probs
    mixed = alpha * targets_onehot + (1 - alpha) * boot
    loss = sigmoid_cross_entropy_with_logits(preds, mixed)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_sigmoid_loss(preds, targets_onehot, weights=None):
    loss = sigmoid_cross_entropy_with_logits(preds, targets_onehot)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_softmax_loss(preds, targets_onehot, weights=None,
                          logit_scale=1.0):
    if logit_scale and logit_scale != 1.0:
        preds = preds / logit_scale
    loss = softmax_cross_entropy_with_logits(preds, targets_onehot)
    if weights is not None:
        loss = loss * weights
    return loss


def _ghm_weights(g, weights, bins, num_codes=1):
    """Each element's gradient-harmonizing weight from its gradient norm
    ``g`` in [0, 1]: num_examples / count[bin] / num_valid_bins, zero
    outside ``weights`` > 0. The histogram is a scatter-add into a
    fixed-size buffer: no host sync. Under a process group the bin
    counts and ``num_examples`` are all-reduced: every rank weighs its
    elements by the global batch's histogram, as JAX's sharded step
    does."""
    if weights is None:
        valid = torch.ones_like(g, dtype=torch.bool)
    else:
        valid = (weights > 0)[..., None].expand(g.shape)
    validf = valid.to(g.dtype)
    num_valid = validf.sum()
    bin_idx = (g * bins).to(torch.int64).clamp(0, bins - 1)
    counts = torch.zeros(bins, dtype=g.dtype, device=g.device).scatter_add_(
        0, torch.where(valid, bin_idx, 0).reshape(-1), validf.reshape(-1))
    if mesh.world() > 1:  # JAX's histogram is over the global batch
        sums = mesh.all_reduce_sum(torch.cat([counts, num_valid.reshape(1)]))
        counts, num_valid = sums[:-1], sums[-1]
    num_examples = (num_valid / num_codes).clamp(min=1.0)
    num_valid_bins = (counts > 0).sum().to(g.dtype).clamp(min=1.0)
    per_bin = torch.where(counts > 0, num_examples / counts.clamp(min=1.0),
                          0.0)
    w = torch.where(valid, per_bin[bin_idx], 0.0) / num_valid_bins
    return w, num_examples


def ghm_c_loss(preds, targets_onehot, weights=None, bins=10):
    """Gradient-harmonized classification loss (GHM-C; reference
    second/pytorch/core/ghm_loss.py:17-75, momentum 0): sigmoid CE of
    each element weighted by the inverse density of its gradient norm
    |sigmoid(x) - y| among the valid elements. [B, A, C] -> [B, A, C]."""
    bins = int(bins)
    g = (torch.sigmoid(preds.detach()) - targets_onehot).abs()
    w, num_examples = _ghm_weights(g, weights, bins)
    ce = sigmoid_cross_entropy_with_logits(preds, targets_onehot)
    return ce * w / num_examples


def ghm_r_loss(preds, targets, weights=None, mu=0.02, bins=10,
               code_weights=None):
    """Gradient-harmonized regression loss (GHM-R; reference
    second/pytorch/core/ghm_loss.py:78-141): the authentic smooth L1
    sqrt(d^2 + mu^2) - mu, weighted by the inverse density of its
    gradient norm |d| / sqrt(d^2 + mu^2). [B, A, C] -> [B, A, C]."""
    bins = int(bins)
    if code_weights is not None:
        cw = _code_weight_tensor(tuple(code_weights), preds.dtype,
                                 preds.device).reshape(-1)
        preds = preds * cw
        targets = targets * cw
    diff = preds - targets
    loss = torch.sqrt(diff * diff + mu * mu) - mu
    d = diff.detach()
    g = (d / torch.sqrt(mu * mu + d * d)).abs()
    w, num_examples = _ghm_weights(g, weights, bins, preds.shape[-1])
    return loss * w / num_examples


# ---------------------------------------------------------------------------
# loss assembly (reference voxelnet.py:704-830)
# ---------------------------------------------------------------------------

NORM_BY_NUM_EXAMPLES = 0
NORM_BY_NUM_POSITIVES = 1
NORM_BY_NUM_POS_NEG = 2
DONT_NORM = 3


def prepare_loss_weights(labels, pos_cls_weight=1.0, neg_cls_weight=1.0,
                         loss_norm_type=NORM_BY_NUM_POSITIVES,
                         dtype=torch.float32):
    """labels [B, A] (-1 ignore, 0 bg, >0 class) -> cls/reg weights + cared."""
    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    cls_weights = (negatives.to(dtype) * neg_cls_weight
                   + positives.to(dtype) * pos_cls_weight)
    reg_weights = positives.to(dtype)
    if loss_norm_type == NORM_BY_NUM_EXAMPLES:
        num_examples = cared.to(dtype).sum(1, keepdim=True).clamp(min=1.0)
        cls_weights = cls_weights / num_examples
        bbox_norm = positives.to(dtype).sum(1, keepdim=True).clamp(min=1.0)
        reg_weights = reg_weights / bbox_norm
    elif loss_norm_type == NORM_BY_NUM_POSITIVES:
        pos_norm = positives.to(dtype).sum(1, keepdim=True).clamp(min=1.0)
        reg_weights = reg_weights / pos_norm
        cls_weights = cls_weights / pos_norm
    elif loss_norm_type == NORM_BY_NUM_POS_NEG:
        pos_neg = torch.stack([positives, negatives], dim=-1).to(dtype)
        normalizer = pos_neg.sum(1, keepdim=True)  # [B, 1, 2]
        cls_normalizer = (pos_neg * normalizer).sum(-1).clamp(min=1.0)
        normalizer = normalizer.clamp(min=1.0)
        reg_weights = reg_weights / normalizer[:, 0:1, 0]
        cls_weights = cls_weights / cls_normalizer
    elif loss_norm_type == DONT_NORM:
        pos_norm = positives.to(dtype).sum(1, keepdim=True).clamp(min=1.0)
        reg_weights = reg_weights / pos_norm
    else:
        raise ValueError(f"unknown loss norm type {loss_norm_type}")
    return cls_weights, reg_weights, cared


def add_sin_difference(boxes1, boxes2, factor=1.0):
    """Replace the two yaw channels with sin-difference encodings."""
    r1 = boxes1[..., 6:7] * factor
    r2 = boxes2[..., 6:7] * factor
    rad_pred = torch.sin(r1) * torch.cos(r2)
    rad_tg = torch.cos(r1) * torch.sin(r2)
    boxes1 = torch.cat([boxes1[..., :6], rad_pred, boxes1[..., 7:]], dim=-1)
    boxes2 = torch.cat([boxes2[..., :6], rad_tg, boxes2[..., 7:]], dim=-1)
    return boxes1, boxes2


def get_direction_target(anchors, reg_targets, dir_offset=0.0, num_bins=2,
                         one_hot=True, dtype=torch.float32):
    """Direction-bin classification targets from yaw residuals."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = rot_gt - dir_offset
    offset_rot = offset_rot - torch.floor(
        offset_rot / (2 * math.pi)) * (2 * math.pi)
    dir_cls = torch.floor(offset_rot / (2 * math.pi / num_bins)).long()
    dir_cls = dir_cls.clamp(0, num_bins - 1)
    if one_hot:
        return F.one_hot(dir_cls, num_bins).to(dtype)
    return dir_cls
