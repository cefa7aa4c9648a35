"""Sparse residual blocks (twin of ``second_tpu/models/sparse_resnet.py``;
reference second/pytorch/models/resnet.py SparseBasicBlock and
SparseBottleneck): residual stacks of submanifold convs that share one
rulebook per active set, built on the device by
``ops.sparse.build_subm_rulebook`` (or taken from a host plan).

Parameters keep the JAX names, so ``utils.from_flax`` loads them as
they are: sparse conv weights ``conv*_w`` [K, Cin, Cout], batch norms
``bn*``, and the flax ``Dense`` layers ``conv1``, ``conv3`` and
``downsample`` as bias-free ``nn.Linear``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sparse
from .layers import MaskedBatchNorm


def _masked(grid, feats):
    return grid._replace(features=torch.where(
        grid.valid[..., None], feats, torch.zeros_like(feats)))


class SparseBasicBlock(nn.Module):
    """subm conv -> BN -> ReLU -> subm conv -> BN -> + identity -> ReLU."""

    def __init__(self, inplanes, planes, kernel=(3, 3, 3)):
        super().__init__()
        k = int(np.prod(kernel))
        self.conv1_w = nn.Parameter(torch.empty(k, inplanes, planes))
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2_w = nn.Parameter(torch.empty(k, planes, planes))
        self.bn2 = MaskedBatchNorm(planes)
        self.downsample = (nn.Linear(inplanes, planes, bias=False)
                           if inplanes != planes else None)

    def forward(self, grid, slots):
        """grid: ``ops.sparse.SparseGrid``; slots [B, V, K] int32, its
        subm rulebook."""
        identity = grid.features
        out = sparse.subm_conv(grid, slots, self.conv1_w)
        out = out._replace(features=F.relu(
            self.bn1(out.features, mask=grid.valid)))
        out = sparse.subm_conv(out, slots, self.conv2_w)
        feats = self.bn2(out.features, mask=grid.valid)
        if self.downsample is not None:
            identity = self.downsample(identity)
        return _masked(out, F.relu(feats + identity))


class SparseBottleneck(nn.Module):
    """1x1 -> 3x3 subm -> 1x1 bottleneck (expansion 4)."""

    expansion = 4

    def __init__(self, inplanes, planes, kernel=(3, 3, 3)):
        super().__init__()
        k = int(np.prod(kernel))
        out_planes = planes * self.expansion
        self.conv1 = nn.Linear(inplanes, planes, bias=False)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2_w = nn.Parameter(torch.empty(k, planes, planes))
        self.bn2 = MaskedBatchNorm(planes)
        self.conv3 = nn.Linear(planes, out_planes, bias=False)
        self.bn3 = MaskedBatchNorm(out_planes)
        self.downsample = (nn.Linear(inplanes, out_planes, bias=False)
                           if inplanes != out_planes else None)

    def forward(self, grid, slots):
        identity = grid.features
        feats = F.relu(self.bn1(self.conv1(grid.features), mask=grid.valid))
        mid = sparse.subm_conv(grid._replace(features=feats), slots,
                               self.conv2_w)
        feats = F.relu(self.bn2(mid.features, mask=grid.valid))
        feats = self.bn3(self.conv3(feats), mask=grid.valid)
        if self.downsample is not None:
            identity = self.downsample(identity)
        return _masked(mid, F.relu(feats + identity))
