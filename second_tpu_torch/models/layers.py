"""Shared layers (twin of ``second_tpu/models/layers.py``)."""

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """Batch norm with the JAX package's parameters (eps 1e-3): weight
    (flax ``scale``), bias, running_mean, running_var.

    In training mode it normalises with the batch statistics over the
    rows ``mask`` selects (every row when ``mask`` is None): biased
    variance normalises, the unbiased variance (n = the masked row count
    over the whole batch) updates the running statistics with torch
    momentum 0.01. In eval mode it uses the running statistics and the
    mask does not enter.
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
        channel_dim = channel_dim % x.dim()
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        if self.training:
            dims = [d for d in range(x.dim()) if d != channel_dim]
            if mask is None:
                n = torch.tensor(float(x.numel() // x.shape[channel_dim]),
                                 device=x.device)
                mean = x.mean(dims)
                var = torch.square(x - mean.view(shape)).mean(dims)
            else:
                m = mask.unsqueeze(channel_dim).to(x.dtype)
                n = m.sum().clamp(min=1.0)
                mean = (x * m).sum(dims) / n
                var = (torch.square(x - mean.view(shape)) * m).sum(dims) / n
            with torch.no_grad():
                unbiased = var * (n / (n - 1.0).clamp(min=1.0))
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                        + (1 - self.momentum) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        y = (x - mean.view(shape)) * inv.view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape)
