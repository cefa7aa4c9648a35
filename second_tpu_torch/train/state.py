"""Train state and the train step (twin of ``second_tpu/train/state.py``
``TrainState`` and ``make_train_step``)."""

import dataclasses

import torch
from torch import nn

from ..models.voxelnet import compute_loss
from ..utils.metrics import classification_metrics
from .optimizer import AdamW


@dataclasses.dataclass
class TrainState:
    """The network's parameters and buffers (batch-norm statistics), the
    optimizer's state and the number of steps taken."""

    net: nn.Module
    optimizer: AdamW
    global_step: int = 0


def forward_loss(net, spec, example):
    """The network in training mode (its batch statistics move) and
    ``compute_loss`` on a device batch (see :func:`make_train_step`)."""
    if "labels_i8" in example:
        raise NotImplementedError(
            "compact_targets examples are not ported; build examples "
            "with dense labels and reg_targets")
    plan = {k: v for k, v in example.items() if k.startswith("plan_")}
    net.train()
    preds = net(example["voxels"], example["num_points"],
                example["coordinates"], plan)
    return compute_loss(spec, preds, example)


def make_train_step(net, spec, optimizer, lr_fn, mom_fn):
    """Returns ``step(example) -> metrics``; ``step.state`` is the
    :class:`TrainState` it updates.

    example: dict of tensors on the network's device: voxels
    [B, V, T, F], num_points [B, V], coordinates [B, V, 3] sorted by
    linear id, the host plan's ``plan_*`` rulebooks, anchors [B, A, 7],
    labels [B, A], reg_targets [B, A, code] and optional importance
    [B, A]. Each call runs the network in training mode (batch
    statistics), the loss and its backward (K1 and K2 in the sparse
    middle), clips the global gradient norm to 10 and steps the
    optimizer at ``lr_fn`` / ``mom_fn`` of its update count, as optax's
    ``inject_hyperparams`` does (the first step uses ``lr_fn(0)``).
    """
    state = TrainState(net, optimizer)
    params = optimizer.params

    def step(example):
        res = forward_loss(net, spec, example)
        grads = torch.autograd.grad(res["loss"], params)
        count = optimizer.count
        lr, b1 = lr_fn(count), mom_fn(count)
        grad_norm = optimizer.step(list(grads), lr, b1)
        state.global_step += 1
        labels = example["labels"]
        metrics = {
            "loss": res["loss"].detach(),
            "cls_loss": res["cls_loss_reduced"].detach(),
            "loc_loss": res["loc_loss_reduced"].detach(),
            "cls_pos_loss": res["cls_pos_loss"].detach(),
            "cls_neg_loss": res["cls_neg_loss"].detach(),
            "num_pos": (labels > 0).sum(),
            "num_neg": (labels == 0).sum(),
            "lr": lr,
            "grad_norm": grad_norm,
        }
        if "dir_loss_reduced" in res:
            metrics["dir_loss"] = res["dir_loss_reduced"].detach()
        with torch.no_grad():
            metrics["cls_stats"] = classification_metrics(
                res["cls_preds"], labels,
                encode_background_as_zeros=spec.encode_background_as_zeros)
        return metrics

    step.state = state
    return step
