"""Voxel feature encoders (twin of ``second_tpu/models/voxel_encoders.py``).

Every encoder of the JAX package: :class:`SimpleVoxel` (car.fhd,
all.fhd), :class:`SimpleVoxelRadius`, the VFE stacks
(:class:`VoxelFeatureExtractor`, :class:`VoxelFeatureExtractorV2`) and
the pillar family (PointPillars): :class:`PillarFeatureNet`,
:class:`PillarFeatureNetOld`, :class:`PillarFeatureNetRadius` and
:class:`PillarFeatureNetRadiusHeight`.

``use_norm=False`` gives each pointwise layer a bias and no batch
norm, as in JAX. Inputs use the static layout: voxels [B, V, T, F]
(zero padding), num_points [B, V], coords [B, V, 3] zyx (-1 padding
rows). The pillar
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
                 voxel_size=(0.2, 0.2, 4), pc_range=(0, -40, -3, 70.4, 40, 1),
                 use_norm=True):
        # the other arguments are the VFE family's common signature;
        # a mean has no parameters
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels, num_points, coords):
        return _voxel_mean(voxels, num_points, self.num_input_features)


def _voxel_mean(voxels, num_points, nf):
    """The mean of each voxel's points [B, V, nf]; voxels that are
    already per-voxel means [B, V, F] pass through."""
    if voxels.dim() == 3:
        return voxels[..., :nf]
    denom = num_points.clamp(min=1).to(voxels.dtype)[..., None]
    return voxels[..., :nf].sum(dim=-2) / denom


@register_vfe
class SimpleVoxelRadius(SimpleVoxel):
    """The voxel's mean point as (radius in xy, z, intensity...)
    (voxel_encoder.py:227-255): [B, V, num_input_features - 1]."""

    def forward(self, voxels, num_points, coords):
        mean = _voxel_mean(voxels, num_points, self.num_input_features)
        radius = torch.linalg.norm(mean[..., :2], dim=-1, keepdim=True)
        return torch.cat([radius, mean[..., 2:]], dim=-1)


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


class VFELayer(nn.Module):
    """Pointwise Linear+BN+ReLU to out_channels / 2, with the max over
    the T slots repeated beside each slot (voxel_encoder.py:50-80)."""

    def __init__(self, in_channels, out_channels, use_norm=True):
        super().__init__()
        self.linear_bn_relu = LinearBNReLU(in_channels, out_channels // 2,
                                           use_norm)

    def forward(self, x, voxel_mask):
        x = self.linear_bn_relu(
            x, mask=voxel_mask[..., None].expand(x.shape[:-1]))
        # amax splits the gradient among tied slots (a voxel's padded
        # slots tie), as JAX's max does
        return torch.cat([x, x.amax(dim=-2, keepdim=True).expand_as(x)],
                         dim=-1)


class _VoxelFeatureExtractorBase(nn.Module):
    """VFELayers of ``num_filters``, then Linear+BN+ReLU to the last
    width and the max over the T slots, masking the padded slots after
    each layer (voxel_encoder.py:82-204): voxels [B, V, T, F] ->
    [B, V, num_filters[-1]]. The input is each point with its offset
    from the voxel's mean (and its distance, ``with_distance``)."""

    def __init__(self, num_input_features=4, num_filters=(32, 128),
                 with_distance=False, voxel_size=(0.2, 0.2, 4),
                 pc_range=(0, -40, -3, 70.4, 40, 1), use_norm=True):
        super().__init__()
        self.with_distance = with_distance
        cin = num_input_features + 3 + int(with_distance)
        self.vfe_layers = nn.ModuleList()
        for out in num_filters:
            self.vfe_layers.append(VFELayer(cin, out, use_norm))
            cin = out
        self.linear_bn_relu = LinearBNReLU(cin, num_filters[-1], use_norm)

    def forward(self, voxels, num_points, coords):
        voxel_mask = num_points > 0
        mask = slot_mask(num_points, voxels.shape[-2], voxels.dtype)
        feats = [voxels, _cluster_offsets(voxels, num_points)]
        if self.with_distance:
            feats.append(
                torch.linalg.norm(voxels[..., :3], dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1)
        for layer in self.vfe_layers:
            x = layer(x, voxel_mask) * mask
        x = self.linear_bn_relu(
            x, mask=voxel_mask[..., None].expand(x.shape[:-1])) * mask
        return x.amax(dim=-2)


@register_vfe
class VoxelFeatureExtractor(_VoxelFeatureExtractorBase):
    """Two VFELayers + the final Linear+BN+ReLU (voxel_encoder.py:82-140)."""

    def __init__(self, num_filters=(32, 128), **kwargs):
        if len(num_filters) != 2:
            raise ValueError("VoxelFeatureExtractor takes two num_filters")
        super().__init__(num_filters=num_filters, **kwargs)


@register_vfe
class VoxelFeatureExtractorV2(_VoxelFeatureExtractorBase):
    """Any number of VFELayers (voxel_encoder.py:142-204)."""


class PFNLayer(nn.Module):
    """Pillar feature net layer (pointpillars.py:17-66): pointwise
    Linear+BN+ReLU, then the max over the T slots; the last layer
    returns the max [..., 1, C], the others each slot's features with
    the max repeated beside them."""

    def __init__(self, in_channels, out_channels, last_layer=False,
                 use_norm=True):
        super().__init__()
        self.last_layer = last_layer
        units = out_channels if last_layer else out_channels // 2
        self.linear_bn_relu = LinearBNReLU(in_channels, units, use_norm)

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
                 pc_range=(0, -40, -3, 70.4, 40, 1), use_norm=True):
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
            self.pfn_layers.append(PFNLayer(cin, out, last_layer=last,
                                            use_norm=use_norm))
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
