"""Rank bodies of ``test_torch_ddp.py``'s collective checks: spawned
processes import their target by name, so they live in a module without
tests (and without JAX)."""

import numpy as np
import torch

from second_tpu_torch.models.layers import MaskedBatchNorm
from second_tpu_torch.ops import losses
from second_tpu_torch.parallel import mesh


def norm_outputs(x, mask, g, weight, bias, channel_dim):
    """A ``MaskedBatchNorm`` in training mode on this process's rows ``x``
    (float64): its output, the gradients of sum(y * g) with respect to
    x, the scale and the bias, and the running statistics after it."""
    bn = MaskedBatchNorm(x.shape[channel_dim]).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = None if mask is None else torch.from_numpy(mask)
    y = bn(xt, mask=mt, channel_dim=channel_dim)
    gx, gw, gb = torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                                     (xt, bn.weight, bn.bias))
    return {"y": y.detach().numpy(), "x": gx.numpy(), "weight": gw.numpy(),
            "bias": gb.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def norm_rank(rank, world_size, init_method, x, mask, g, weight, bias,
              channel_dim):
    """:func:`norm_outputs` on this rank's rows of the global ``x``."""
    mesh.make_mesh("cpu", "gloo", init_method, rank, world_size)
    rows = mesh.shard_example(len(x))
    return norm_outputs(x[rows], None if mask is None else mask[rows],
                        g[rows], weight, bias, channel_dim)


def ghm_rank(rank, world_size, init_method, kind, preds, targets, weights):
    """GHM-C or GHM-R on this rank's rows of the global batch."""
    mesh.make_mesh("cpu", "gloo", init_method, rank, world_size)
    rows = mesh.shard_example(len(preds))
    p, t, w = (torch.from_numpy(np.ascontiguousarray(a[rows]))
               for a in (preds, targets, weights))
    if kind == "c":
        return losses.ghm_c_loss(p, t, w, bins=10).numpy()
    return losses.ghm_r_loss(p, t, w, mu=0.02, bins=10).numpy()
