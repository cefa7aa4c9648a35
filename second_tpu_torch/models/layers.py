"""Shared layers (twin of ``second_tpu/models/layers.py``)."""

import numpy as np
import torch
from torch import nn

from ..parallel import mesh


def promoted(x, dtype):
    """x in the promoted dtype of its own and ``dtype`` (flax's and
    jnp's promotion: bf16 with f32 is f32, f64 stays f64)."""
    return x.to(torch.promote_types(x.dtype, dtype))


class MaskedBatchNorm(nn.Module):
    """Batch norm with the JAX package's parameters (eps 1e-3): weight
    (flax ``scale``), bias, running_mean, running_var.

    In training mode it normalises with the batch statistics over the
    rows ``mask`` selects (every row when ``mask`` is None): biased
    variance normalises, the unbiased variance (n = the masked row count
    over the whole batch) updates the running statistics with torch
    momentum 0.01. Under a process group the batch is the global one,
    every rank's rows, as in JAX's sharded step: the sums (masked: the
    sum and the count, then the squared deviations from the global mean,
    two passes as JAX's variance) go through differentiable all-reduces
    (``mesh.all_reduce_sum``, the identity at world size 1), so the
    running statistics agree across the ranks. In eval mode it uses
    the running statistics and the mask does not enter. Statistics and
    the affine run in f32 (f64 for f64 inputs), the output is in x's
    dtype (bf16 under mixed precision) and the running statistics stay
    f32, as in JAX.
    """

    momentum = 0.99  # flax convention: decay of the running statistics

    def __init__(self, num_features, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, mask=None, channel_dim=-1):
        """x with channels on ``channel_dim``; mask bool of x's shape
        without the channel dimension."""
        dtype = x.dtype
        x = promoted(x, torch.float32)
        channel_dim = channel_dim % x.dim()
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        if self.training:
            dims = [d for d in range(x.dim()) if d != channel_dim]
            if mask is None:
                # n / (n - 1) in float32 on the host: a device scalar made
                # from a host number would be a synchronising copy. Every
                # rank holds as many rows, so the global moments are the
                # ranks' mean moments
                w = mesh.world()
                n = np.float32(w * (x.numel() // x.shape[channel_dim]))
                bessel = float(n / max(n - np.float32(1.0), np.float32(1.0)))
                mean = mesh.all_reduce_sum(x.mean(dims)) / w
                var = mesh.all_reduce_sum(
                    torch.square(x - mean.view(shape)).mean(dims)) / w
            else:
                m = mask.unsqueeze(channel_dim).to(x.dtype)
                sums = mesh.all_reduce_sum(
                    torch.cat([(x * m).sum(dims), m.sum().reshape(1)]))
                n = sums[-1].clamp(min=1.0)
                bessel = n / (n - 1.0).clamp(min=1.0)
                mean = sums[:-1] / n
                var = mesh.all_reduce_sum(
                    (torch.square(x - mean.view(shape)) * m).sum(dims)) / n
            with torch.no_grad():
                unbiased = var * bessel
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                        + (1 - self.momentum) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        y = (x - mean.view(shape)) * inv.view(shape)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(dtype)

    def affine(self):
        """Eval-mode batch norm as y = x * k + b (the flat pillar path's
        form; JAX ``pp_fast._affine_from_bn``)."""
        k = self.weight / torch.sqrt(self.running_var + self.eps)
        return k, self.bias - self.running_mean * k


class LinearBNReLU(nn.Module):
    """A linear layer, then :class:`MaskedBatchNorm`, then ReLU, on the
    last dimension (the JAX ``LinearBNReLU``): bias-free with the norm
    (``use_norm``), biased without it, as the reference's layers are."""

    def __init__(self, in_features, out_features, use_norm=True):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features, bias=not use_norm)
        if use_norm:
            self.bn = MaskedBatchNorm(out_features)

    def forward(self, x, mask=None):
        """``mask``: bool of x's shape without the channel dimension."""
        x = self.linear(x)
        if hasattr(self, "bn"):
            x = self.bn(x, mask=mask)
        return torch.relu(x)

    def affine(self):
        """What follows the bias-free product in eval mode, as
        y = (x @ W^T) * k + b: the batch norm's affine, or the linear
        layer's bias."""
        if hasattr(self, "bn"):
            return self.bn.affine()
        return torch.ones_like(self.linear.bias), self.linear.bias
