"""Optimizer construction (twin of ``second_tpu/train/optimizer.py``).

Reproduces the reference's fastai OptimWrapper semantics
(second/pytorch/builder/optimizer_builder.py + torchplus/train/
fastai_optim.py:154-167) as the JAX package's optax chain does:
grad-clip by global norm 10.0 before the step (train.py:323), then Adam
with ``fixed_weight_decay`` (true AdamW: the decay ``wd * p`` is added
after the Adam ratio, as ``optax.adamw``) or classic L2-in-gradient
decay, with weight decay on ALL parameters including norm scales and
biases (bn_wd=True upstream). The OneCycle momentum annealing drives
Adam's b1.

The update is written out in torch to mirror optax under
``inject_hyperparams`` exactly, rather than trusting
``torch.optim.AdamW``'s conventions (it decays before the Adam ratio and
its clipping adds 1e-6 to the norm). The momentum and RMSProp
optimizers are not ported yet and raise.
"""

import torch

from ..configs import schema
from . import schedules

GRAD_CLIP_NORM = 10.0


def clip_by_global_norm(grads, max_norm):
    """optax.clip_by_global_norm: scale every gradient by
    ``max_norm / norm`` when the global norm is at least ``max_norm``,
    else leave them as they are. Returns the norm."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class AdamW:
    """Adam over ``params`` (a list of tensors, updated in place) with
    the optax chain ``clip_by_global_norm(10)`` -> ``adamw`` (or
    ``add_decayed_weights`` -> ``scale_by_adam`` -> ``-lr``).

    ``count`` is optax's update count: the step-th update (from 0) uses
    the schedules at ``count`` and bias-corrects with ``count + 1`` and
    the current b1. With ``ema_decay`` it also keeps an exponential
    moving average of the updated parameters (the JAX package's
    ``use_moving_average``).
    """

    def __init__(self, params, weight_decay, fixed_weight_decay, b2=0.999,
                 eps=1e-8, ema_decay=None):
        self.params = list(params)
        self.weight_decay = weight_decay
        self.fixed_weight_decay = fixed_weight_decay
        self.b2 = b2
        self.eps = eps
        self.ema_decay = ema_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.ema = ([p.detach().clone() for p in self.params]
                    if ema_decay is not None else None)
        self.count = 0

    @torch.no_grad()
    def step(self, grads, lr, b1):
        """One update with the gradients ``grads`` (clipped in place)
        at learning rate ``lr`` and Adam b1 ``b1``. Returns the
        gradients' global norm before clipping."""
        norm = clip_by_global_norm(grads, GRAD_CLIP_NORM)
        wd, b2 = self.weight_decay, self.b2
        self.count += 1
        bc1 = 1 - b1 ** self.count
        bc2 = 1 - b2 ** self.count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if not self.fixed_weight_decay:
                g = g + wd * p
            self.mu[i] = (1 - b1) * g + b1 * self.mu[i]
            self.nu[i] = (1 - b2) * torch.square(g) + b2 * self.nu[i]
            u = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + self.eps)
            if self.fixed_weight_decay:
                u = u + wd * p
            p.add_(-lr * u)
        if self.ema is not None:
            d = self.ema_decay
            for e, p in zip(self.ema, self.params):
                e.copy_(d * e + (1.0 - d) * p)
        return norm


def build(optimizer_config: schema.Optimizer, total_step, params):
    """Optimizer proto -> (AdamW over ``params``, lr_fn, mom_fn)."""
    which = optimizer_config.WhichOneof("optimizer")
    if which in ("momentum_optimizer", "rms_prop_optimizer"):
        raise NotImplementedError(f"{which} is not ported yet")
    if which != "adam_optimizer":
        raise ValueError("empty optimizer config")
    cfg = optimizer_config.adam_optimizer
    if cfg.amsgrad:
        raise NotImplementedError("amsgrad not supported")
    lr_fn, mom_fn = schedules.build(
        cfg.learning_rate, total_step, default_momentum=0.9)
    ema_decay = None
    if optimizer_config.use_moving_average:
        ema_decay = optimizer_config.moving_average_decay or 0.9999
    opt = AdamW(params, cfg.weight_decay,
                optimizer_config.fixed_weight_decay, ema_decay=ema_decay)
    return opt, lr_fn, mom_fn
