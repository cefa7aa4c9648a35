"""Voxel feature encoders (twin of ``second_tpu/models/voxel_encoders.py``).

Ported: :class:`SimpleVoxel` (car.fhd) and the pillar family
(PointPillars): :class:`PillarFeatureNet`, :class:`PillarFeatureNetOld`,
:class:`PillarFeatureNetRadius` and :class:`PillarFeatureNetRadiusHeight`.

Inputs use the static layout: voxels [B, V, T, F] (zero padding),
num_points [B, V], coords [B, V, 3] zyx (-1 padding rows). The pillar
family masks the padded T slots once, before the PFN stack, and lets
their ``relu(BN(Linear(0)))`` join each max, as the JAX modules (and the
reference, pointpillars.py:52-66) do; the inference fast path
``models.pp_fast`` is held against this one.
"""

import torch
from torch import nn

from .layers import LinearBNReLU
from .registry import register_vfe


@register_vfe
class SimpleVoxel(nn.Module):
    """Mean of each voxel's points: voxels [B, V, T, F] with counts
    [B, V] -> [B, V, num_input_features]; voxels that are already
    per-voxel means [B, V, F] pass through."""

    def __init__(self, num_input_features=4, num_filters=(32, 128),
                 with_distance=False,
                 voxel_size=(0.2, 0.2, 4), pc_range=(0, -40, -3, 70.4, 40, 1)):
        # the other arguments are the VFE family's common signature;
        # a mean has no parameters
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels, num_points, coords):
        nf = self.num_input_features
        if voxels.dim() == 3:
            return voxels[..., :nf]
        denom = num_points.clamp(min=1).to(voxels.dtype)[..., None]
        return voxels[..., :nf].sum(dim=-2) / denom


def slot_mask(num_points, max_t, dtype=torch.float32):
    """[B, V] counts -> [B, V, T, 1] validity of each slot (reference
    get_paddings_indicator, voxel_encoder.py:27-48)."""
    ids = torch.arange(max_t, device=num_points.device).view(1, 1, -1)
    return (ids < num_points[..., None]).to(dtype)[..., None]


def _cluster_offsets(voxels, num_points):
    """xyz offsets from each voxel's point mean (the padded slots, zero,
    join the sum)."""
    denom = num_points.clamp(min=1).to(voxels.dtype)[..., None, None]
    mean = voxels[..., :3].sum(dim=-2, keepdim=True) / denom
    return voxels[..., :3] - mean


class PFNLayer(nn.Module):
    """Pillar feature net layer (pointpillars.py:17-66): pointwise
    Linear+BN+ReLU, then the max over the T slots; the last layer
    returns the max [..., 1, C], the others each slot's features with
    the max repeated beside them."""

    def __init__(self, in_channels, out_channels, last_layer=False):
        super().__init__()
        self.last_layer = last_layer
        units = out_channels if last_layer else out_channels // 2
        self.linear_bn_relu = LinearBNReLU(in_channels, units)

    def forward(self, x, voxel_mask):
        # batch statistics (training) over every slot of the real voxels
        x = self.linear_bn_relu(
            x, mask=voxel_mask[..., None].expand(x.shape[:-1]))
        x_max = x.max(dim=-2, keepdim=True).values
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class _PillarFeatureNetBase(nn.Module):
    """Shared pillar decoration + PFN stack (pointpillars.py:67-413):
    voxels [B, V, T, F] -> pillar features [B, V, num_filters[-1]]."""

    radius = False
    height = False
    # "Old" variant quirk (pointpillars.py:119-137): f_center is an
    # in-place view of the raw xy columns, so the decorated vector ends
    # up with xy REPLACED by the pillar-centre offsets (and duplicated)
    center_replaces_xy = False

    def __init__(self, num_input_features=4, num_filters=(64,),
                 with_distance=False, voxel_size=(0.2, 0.2, 4),
                 pc_range=(0, -40, -3, 70.4, 40, 1)):
        super().__init__()
        self.num_input_features = num_input_features
        self.with_distance = with_distance
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        cin = (num_input_features + 5 - int(self.radius) + int(self.height)
               + int(with_distance))
        nf = list(num_filters)
        self.pfn_layers = nn.ModuleList()
        for i, out in enumerate(nf):
            last = i == len(nf) - 1
            self.pfn_layers.append(PFNLayer(cin, out, last_layer=last))
            cin = out

    def forward(self, voxels, num_points, coords):
        voxel_mask = num_points > 0
        dtype = voxels.dtype
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x_offset = vx / 2 + self.pc_range[0]
        y_offset = vy / 2 + self.pc_range[1]

        f_cluster = _cluster_offsets(voxels, num_points)
        # pillar-centre offsets from the zyx int coords
        px = coords[..., 2:3].to(dtype) * vx + x_offset  # [B, V, 1]
        py = coords[..., 1:2].to(dtype) * vy + y_offset
        f_center = torch.stack(
            [voxels[..., 0] - px, voxels[..., 1] - py], dim=-1)

        if self.radius:
            r = torch.linalg.norm(voxels[..., :2], dim=-1, keepdim=True)
            base = torch.cat([r, voxels[..., 2:]], dim=-1)
        elif self.center_replaces_xy:
            base = torch.cat([f_center, voxels[..., 2:]], dim=-1)
        else:
            base = voxels
        feats = [base, f_cluster, f_center]
        if self.height:
            # over the raw slots, padding zeros included
            z = voxels[..., 2:3]
            dz = (z.max(dim=-2, keepdim=True).values
                  - z.min(dim=-2, keepdim=True).values)
            feats.append(dz.expand_as(z))
        if self.with_distance:
            feats.append(
                torch.linalg.norm(voxels[..., :3], dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1)
        x = x * slot_mask(num_points, voxels.shape[-2], dtype)
        for layer in self.pfn_layers:
            x = layer(x, voxel_mask)
        return x[..., 0, :]  # squeeze the pooled T axis


@register_vfe
class PillarFeatureNet(_PillarFeatureNetBase):
    pass


@register_vfe
class PillarFeatureNetOld(_PillarFeatureNetBase):
    center_replaces_xy = True


@register_vfe
class PillarFeatureNetRadius(_PillarFeatureNetBase):
    radius = True


@register_vfe
class PillarFeatureNetRadiusHeight(_PillarFeatureNetBase):
    radius = True
    height = True
