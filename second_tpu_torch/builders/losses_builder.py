"""Loss functors from proto config (twin of
``second_tpu/builders/losses_builder.py``; reference
second/pytorch/builder/losses_builder.py:23-190).

Returns plain closures over :mod:`second_tpu_torch.ops.losses`.
"""

import functools

from ..configs import schema
from ..ops import losses as L


def _build_classification(cfg: schema.ClassificationLoss):
    which = cfg.WhichOneof("classification_loss")
    if which == "weighted_sigmoid":
        return L.weighted_sigmoid_loss
    if which == "weighted_sigmoid_focal":
        c = cfg.weighted_sigmoid_focal
        alpha = c.alpha if c.alpha > 0 else None
        return functools.partial(
            L.sigmoid_focal_loss, gamma=c.gamma, alpha=alpha)
    if which == "weighted_softmax_focal":
        c = cfg.weighted_softmax_focal
        alpha = c.alpha if c.alpha > 0 else None
        return functools.partial(
            L.softmax_focal_loss, gamma=c.gamma, alpha=alpha)
    if which == "weighted_softmax":
        c = cfg.weighted_softmax
        return functools.partial(
            L.weighted_softmax_loss, logit_scale=c.logit_scale or 1.0)
    if which == "bootstrapped_sigmoid":
        c = cfg.bootstrapped_sigmoid
        return functools.partial(
            L.bootstrapped_sigmoid_loss, alpha=c.alpha,
            hard_bootstrap=c.hard_bootstrap)
    if which == "weighted_ghm":
        c = cfg.weighted_ghm
        return functools.partial(L.ghm_c_loss, bins=c.bins or 10)
    raise ValueError("empty classification loss config")


def _build_localization(cfg: schema.LocalizationLoss):
    which = cfg.WhichOneof("localization_loss")
    if which == "weighted_l2":
        c = cfg.weighted_l2
        cw = list(c.code_weight) or None
        return functools.partial(L.weighted_l2_loss, code_weights=cw)
    if which == "weighted_smooth_l1":
        c = cfg.weighted_smooth_l1
        cw = list(c.code_weight) or None
        return functools.partial(
            L.weighted_smooth_l1_loss, sigma=c.sigma, code_weights=cw)
    if which == "weighted_ghm":
        c = cfg.weighted_ghm
        cw = list(c.code_weight) or None
        return functools.partial(
            L.ghm_r_loss, mu=c.mu or 0.02, bins=c.bins or 10,
            code_weights=cw)
    raise ValueError("empty localization loss config")


def build(loss_config: schema.Loss):
    """Returns (cls_loss_fn, loc_loss_fn, cls_weight, loc_weight)."""
    return (
        _build_classification(loss_config.classification_loss),
        _build_localization(loss_config.localization_loss),
        loss_config.classification_weight,
        loss_config.localization_weight,
    )
