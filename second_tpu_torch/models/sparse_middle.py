"""Sparse 3D middle extractors, the SECOND middle family (twin of
``second_tpu/models/sparse_middle.py``): SpMiddleFHD, SpMiddleFHDPeople,
SpMiddleFHDLite, SpMiddleFHDLiteHRZ, SpMiddleFHDHRZ and SpMiddle2K; and
SpMiddleResNetFHD, the residual middle of nuScenes' voxel detectors
(OpenPCDet's ``VoxelResBackBone8x``), which the JAX package lacks.

Each scale runs submanifold convs (alone, or in pairs inside residual
blocks, ``models.sparse_resnet.SparseBasicBlock``) and a closing strided
conv through the gather-GEMM kernel K1, over rulebooks from one of two
routes:

* the host plan (:func:`build_host_plan`, the C++ planner of
  ``second_tpu_torch.native.sparse_plan``), shipped with the example as
  ``plan_*`` arrays and voxels sorted by linear id: the training and
  evaluation loaders' route, whose threads hide the planner behind the
  step;
* no plan (None or empty): :func:`build_device_plan` builds the same
  rulebooks on the device from the voxel coords (``ops.sparse``'s
  builders), as the JAX package does when it has no host plan: every
  request of ``core.inference.InferenceContext`` (host voxels sorted by
  linear id, or points voxelized on the device) and the loaders'
  ``device_voxelize`` route. The stages' (true active, capacity) counts
  then come back as a device tensor.

From ``dense_from_scale`` on, the convs run as masked dense ``conv3d``
over the scattered grid: inactive inputs are zero, so a subm conv is
``mask * conv(x)``, and a strided conv's active set is every output
whose window touches an active input, found by convolving the
occupancy mask. The output is the NCHW BEV pseudo-image
[B, C*D, H, W] with channel index c*D + d, as in JAX.

With ``compute_dtype`` (bf16 under mixed precision) the voxel features
are cast at the entry and each weight at its use, as in JAX: the sparse
convs run K1-bf16 and the dense tail's ``conv3d`` runs in bf16, while
batch norm keeps f32 statistics and the occupancy-mask conv stays f32
(exact).

The JAX package's banded plans and z-folded dense weights are TPU
workarounds and have no counterpart here.
"""

import contextlib
import logging

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..native import sparse_plan as native_plan
from ..ops import sparse
from ..ops.cuda_sparse_conv import NARROW_MAX
from ..utils import timer
from .layers import MaskedBatchNorm
from .registry import get_middle_class, register_middle
from .sparse_resnet import SparseBasicBlock


def _t3(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def _group_topology(topology):
    """Split ops into per-scale groups (subm ops + closing down op)."""
    groups, cur = [], []
    for op in topology:
        cur.append(op)
        if op[0] == "down":
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)
    return groups


def _out_capacity(cur_cap, factor):
    return max(int(-(-cur_cap * factor // 128)) * 128, 128)


def _down_out_shape(shape, kernel, stride, pad):
    out = sparse._down_shape(shape, kernel, stride, pad)
    if any(s <= 0 for s in out):
        raise ValueError(
            f"strided sparse conv collapses grid {tuple(shape)} -> {out} "
            f"(kernel {kernel}, stride {stride}, pad {pad}): the input "
            "grid is too shallow for this topology")
    return out


def plan_scales(middle_class_name, output_shape, max_voxels):
    """Static per-scale planning info for either rulebook route, the
    same grouping and capacity schedule as the JAX package's.

    Returns a list of dicts: {"shape", "in_cap", "subm_kernels",
    "down": (kernel, stride, pad) | None, "out_cap", "out_shape",
    "dense"}.
    """
    return _scales(get_middle_class(middle_class_name), output_shape,
                   max_voxels)


def _scales(cls, output_shape, max_voxels):
    nz, ny, nx = (int(v) for v in output_shape[1:4])
    shape = (nz + 1, ny, nx)
    cap = int(max_voxels)
    scales = []
    down_idx = 0
    for group in _group_topology(cls.topology):
        subm_kernels = []
        for op in group:
            # a residual block's two subm convs share the scale's rulebook
            if op[0] in ("subm", "block") and _t3(op[2]) not in subm_kernels:
                subm_kernels.append(_t3(op[2]))
        entry = {
            "shape": shape,
            "in_cap": cap,
            "subm_kernels": subm_kernels,
            "down": None,
            "out_cap": None,
            "out_shape": None,
            "dense": (cls.dense_from_scale is not None
                      and len(scales) >= cls.dense_from_scale),
        }
        if group[-1][0] == "down":
            _, _, kernel, stride, pad = group[-1]
            kernel, stride, pad = _t3(kernel), _t3(stride), _t3(pad)
            factor = (cls.capacity_factors[down_idx]
                      if down_idx < len(cls.capacity_factors) else 1.0)
            out_cap = _out_capacity(cap, factor)
            out_shape = _down_out_shape(shape, kernel, stride, pad)
            entry.update(down=(kernel, stride, pad), out_cap=out_cap,
                         out_shape=out_shape)
            shape, cap = out_shape, out_cap
            down_idx += 1
        scales.append(entry)
    return scales


def build_host_plan(coords, scales, return_counts=False):
    """Run the C++ planner over every sparse scale. coords: [V, 3] int32
    zyx sorted by linear id with -1 padding rows. Returns a dict of
    int32 arrays: plan_subm{i} [V_i, K], plan_coords{i} [V_{i+1}, 3],
    plan_conv{i} [V_{i+1}, K]; a miss slot is V_i. With
    return_counts=True also returns {scale: (true_active, capacity)}.

    Slots stay int32 (the JAX package narrows them to uint16 to halve
    the TPU upload); a capacity overflow drops voxels and warns.
    """
    plan = {}
    counts = {}
    for i, sc in enumerate(scales):
        if sc["dense"]:
            break  # dense-tail scales run as conv3d: no rulebooks
        shape = sc["shape"]
        if sc["subm_kernels"]:
            if len(sc["subm_kernels"]) != 1:
                raise ValueError("one subm kernel per scale expected")
            kernel = sc["subm_kernels"][0]
            pad = np.array([(k - 1) // 2 for k in kernel])
            offs = sparse._kernel_offsets(kernel) - pad
            plan[f"plan_subm{i}"] = native_plan.subm_plan(coords, shape, offs)
        if sc["down"] is not None:
            kernel, stride, padding = sc["down"]
            out_coords, conv_slots, total = native_plan.down_plan(
                coords, shape, kernel, stride, padding,
                sparse._kernel_offsets(kernel), sc["out_cap"])
            counts[i] = (total, sc["out_cap"])
            if total > sc["out_cap"]:
                warn_overflow(i, total, sc["out_cap"])
            plan[f"plan_coords{i}"] = out_coords
            plan[f"plan_conv{i}"] = conv_slots
            coords = out_coords
    if return_counts:
        return plan, counts
    return plan


def build_device_plan(grid, scales):
    """The host plan's rulebooks built on the device (the twin of the
    JAX package's plan-less ``SparseMiddleBase.__call__``).

    grid: the input ``ops.sparse.SparseGrid`` at scales[0]'s shape.
    Per scale one lookup answers the subm kernel's neighbours and the
    closing strided conv's inputs, after
    ``ops.sparse.downsample_active_set`` has cut that conv's output set
    at the scale's capacity. Returns the plan dict of
    :func:`build_host_plan`'s keys, batched [B, ...] (slots int32, a
    miss V_i; coords int32), and the downsample stages' (true active,
    capacity) counts [B, S, 2] int64, all on the grid's device; nothing
    here reads them on the host.
    """
    plan, counts = {}, []
    for i, sc in enumerate(scales):
        if sc["dense"]:
            break
        if grid.shape != tuple(sc["shape"]):
            raise ValueError(f"scale {i}: grid {grid.shape} is not the "
                             f"plan's {sc['shape']}")
        queries, out_grid = [], None
        if sc["subm_kernels"]:
            if len(sc["subm_kernels"]) != 1:
                raise ValueError("one subm kernel per scale expected")
            qlin, qok, _ = sparse.subm_queries(grid, sc["subm_kernels"][0])
            queries.append((qlin, qok))
        if sc["down"] is not None:
            kernel, stride, pad = sc["down"]
            out_grid, total = sparse.downsample_active_set(
                grid, kernel, stride, pad, out_capacity=sc["out_cap"],
                return_count=True)
            counts.append(torch.stack(
                [total, torch.full_like(total, sc["out_cap"])], -1))
            dlin, dok, _ = sparse.sparse_conv_queries(
                grid, out_grid, kernel, stride, pad)
            queries.append((dlin, dok))
        found = sparse.lookup_many(grid.lin, queries, grid.sentinel)
        b, v = grid.lin.shape
        # K1 takes contiguous slots; a batch's split answers are views
        if sc["subm_kernels"]:
            plan[f"plan_subm{i}"] = found[0][0].reshape(b, v, -1).contiguous()
        if out_grid is not None:
            plan[f"plan_coords{i}"] = out_grid.coords
            plan[f"plan_conv{i}"] = found[-1][0].reshape(
                b, sc["out_cap"], -1).contiguous()
            grid = out_grid
    return plan, (torch.stack(counts, 1) if counts else None)


_overflow_warned = set()


def warn_overflow(scale_idx, total, cap):
    """Once per scale: dropped voxels change detections silently
    otherwise."""
    if scale_idx in _overflow_warned:
        return
    _overflow_warned.add(scale_idx)
    logging.getLogger(__name__).warning(
        "sparse active-set OVERFLOW at downsample stage %d: %d active "
        "voxels > static capacity %d — %d voxels DROPPED. Raise "
        "capacity_factors on the middle class (or lower "
        "max_number_of_voxels). Detections may be lost.",
        scale_idx, total, cap, total - cap)


# topology ops: ("subm", out_ch, kernel) | ("down", out_ch, kernel, stride,
# pad) | ("block", out_ch, kernel): a SparseBasicBlock (subm conv, BN,
# ReLU, subm conv, BN, + identity, ReLU) at out_ch in and out
FHD_TOPOLOGY = (
    ("subm", 16, 3), ("subm", 16, 3),
    ("down", 32, 3, 2, 1),
    ("subm", 32, 3), ("subm", 32, 3),
    ("down", 64, 3, 2, 1),
    ("subm", 64, 3), ("subm", 64, 3), ("subm", 64, 3),
    ("down", 64, 3, 2, (0, 1, 1)),
    ("subm", 64, 3), ("subm", 64, 3), ("subm", 64, 3),
    ("down", 64, (3, 1, 1), (2, 1, 1), 0),
)


FHD_PEOPLE_TOPOLOGY = (
    ("subm", 16, 3), ("subm", 16, 3),
    ("down", 32, 3, 2, 1),
    ("subm", 32, 3), ("subm", 32, 3),
    ("down", 64, 3, 2, (0, 1, 1)),
    ("subm", 64, 3), ("subm", 64, 3), ("subm", 64, 3),
    ("down", 64, (3, 1, 1), (2, 1, 1), 0),
)

FHD_LITE_TOPOLOGY = (
    ("down", 16, 3, 2, 1),
    ("down", 32, 3, 2, 1),
    ("down", 64, 3, 2, (0, 1, 1)),
    ("down", 64, (3, 1, 1), (2, 1, 1), 0),
)

# taller-z (HRZ) variants: 5 downsample stages
FHD_LITE_HRZ_TOPOLOGY = (
    ("down", 32, 3, 2, 1),
    ("down", 64, 3, 2, 1),
    ("down", 64, 3, 2, 1),
    ("down", 64, (3, 1, 1), (2, 1, 1), 0),
    ("down", 64, (3, 1, 1), (2, 1, 1), 0),
)

FHD_HRZ_TOPOLOGY = (
    ("subm", 16, 3), ("subm", 16, 3),
    ("down", 32, 3, 2, 1),
    ("subm", 32, 3), ("subm", 32, 3),
    ("down", 64, 3, 2, 1),
    ("subm", 64, 3), ("subm", 64, 3),
    ("down", 64, 3, 2, 1),
    ("subm", 64, 3), ("subm", 64, 3),
    ("down", 64, (3, 1, 1), (2, 1, 1), 0),
    ("subm", 64, 3), ("subm", 64, 3),
    ("down", 64, (3, 1, 1), (2, 1, 1), 0),
)

# 2k-resolution variant: an 8-channel stage up front
MIDDLE_2K_TOPOLOGY = (
    ("subm", 8, 3), ("subm", 8, 3),
    ("down", 16, 3, 2, 1),
    ("subm", 16, 3), ("subm", 16, 3),
    ("down", 32, 3, 2, 1),
    ("subm", 32, 3), ("subm", 32, 3),
    ("down", 64, 3, 2, 1),
    ("subm", 64, 3), ("subm", 64, 3), ("subm", 64, 3),
    ("down", 64, 3, 2, (0, 1, 1)),
    ("subm", 64, 3), ("subm", 64, 3), ("subm", 64, 3),
    ("down", 64, (3, 1, 1), (2, 1, 1), 0),
)


# OpenPCDet's VoxelResBackBone8x (det3d's SpMiddleResNetFHD): conv_input,
# then per scale a strided conv (conv2-conv4) and two residual blocks
# (conv1-conv4), then conv_out
RESNET_FHD_TOPOLOGY = (
    ("subm", 16, 3),
    ("block", 16, 3), ("block", 16, 3),
    ("down", 32, 3, 2, 1),
    ("block", 32, 3), ("block", 32, 3),
    ("down", 64, 3, 2, 1),
    ("block", 64, 3), ("block", 64, 3),
    ("down", 128, 3, 2, (0, 1, 1)),
    ("block", 128, 3), ("block", 128, 3),
    ("down", 128, (3, 1, 1), (2, 1, 1), 0),
)


class SparseMiddleBase(nn.Module):
    """Shared engine; subclasses set ``topology``, ``dense_from_scale``
    and ``capacity_factors``.

    Parameters keep the JAX names and layouts: ``subm{li}_w`` /
    ``down{li}_w`` [K, Cin, Cout] (bias-free) and ``bn{li}``, one per
    op, or without a norm (``use_norm=False``) a bias ``subm{li}_b`` /
    ``down{li}_b`` [Cout] in place of ``bn{li}``; they stay f32 under a
    ``compute_dtype`` (a torch dtype, or None for f32), which casts
    them at use. A "block" op is the module ``block{li}``
    (``sparse_resnet.SparseBasicBlock``: ``conv1_w``, ``bn1``,
    ``conv2_w``, ``bn2``); such a middle runs in f32 with its norms only.
    """

    topology = FHD_TOPOLOGY
    dense_from_scale = None
    capacity_factors = (3.25, 1.05, 0.56, 0.88)

    def __init__(self, output_shape, num_input_features=128,
                 num_filters_down1=(64,), num_filters_down2=(64, 64),
                 compute_dtype=None, use_norm=True):
        super().__init__()
        self.output_shape = tuple(int(v) for v in output_shape)
        self.compute_dtype = compute_dtype
        self.use_norm = use_norm
        if any(op[0] == "block" for op in self.topology):
            if compute_dtype is not None:
                raise ValueError(
                    f"{type(self).__name__} runs in float32 only: K1-bf16 "
                    "and K2 at 128 channels wait in ROADMAP.md queue 6")
            if not use_norm:
                raise ValueError(f"{type(self).__name__}'s residual blocks "
                                 "have no bias-only form (use_norm=False)")
        # the first op above K1's narrow widths: from it on, the ops run
        # under "net.middle.wide"
        self.wide_from = next((li for li, op in enumerate(self.topology)
                               if op[1] > NARROW_MAX), None)
        cin = num_input_features
        for li, op in enumerate(self.topology):
            cout, kernel = op[1], _t3(op[2])
            if op[0] == "block":
                if cin != cout:
                    raise ValueError(f"op {li}: a block keeps its width, "
                                     f"not {cin} -> {cout}")
                self.add_module(f"block{li}",
                                SparseBasicBlock(cin, cout, kernel))
                continue
            k = int(np.prod(kernel))
            self.register_parameter(
                f"{op[0]}{li}_w", nn.Parameter(torch.empty(k, cin, cout)))
            if use_norm:
                self.add_module(f"bn{li}", MaskedBatchNorm(cout))
            else:
                self.register_parameter(
                    f"{op[0]}{li}_b", nn.Parameter(torch.zeros(cout)))
            cin = cout

    def _weight(self, op, li):
        w = getattr(self, f"{op[0]}{li}_w")
        return w if self.compute_dtype is None else w.to(self.compute_dtype)

    def _bias(self, op, li):
        """The op's bias (``use_norm=False``), or None. JAX casts only
        the weight, so a bias promotes a bf16 output to f32."""
        return None if self.use_norm else getattr(self, f"{op[0]}{li}_b")

    def _norm_relu(self, x, li, mask, channel_dim):
        """Batch norm (statistics over the active rows ``mask`` in
        training), where the middle has one, and ReLU."""
        if not self.use_norm:
            return F.relu(x)
        return F.relu(getattr(self, f"bn{li}")(
            x, mask=mask, channel_dim=channel_dim))

    def forward(self, voxel_features, coords, plan=None, intermediates=None):
        """voxel_features [B, V, C], coords [B, V, 3] int32 zyx.

        plan: the host plan's arrays batched [B, ...] as int32 tensors on
        the features' device, the voxels sorted by linear id; None or
        empty: the rulebooks are built on the device
        (:func:`build_device_plan`, the voxels in any order), and a dict
        ``intermediates`` receives the stages' counts [B, S, 2] under
        "sparse_active_counts" (the JAX package sows them as
        ``active_scale{i}``). The ops from ``wide_from`` to the end of
        the sparse scales run inside the span "net.middle.wide"."""
        nz, ny, nx = self.output_shape[1:4]
        shape = (nz + 1, ny, nx)
        if self.compute_dtype is not None:
            voxel_features = voxel_features.to(self.compute_dtype)
        if plan:
            grid = sparse.from_sorted_voxel_coords(voxel_features, coords,
                                                   shape)
        else:
            grid = sparse.from_voxel_coords(voxel_features, coords, shape)
            plan, counts = build_device_plan(grid, _scales(
                type(self), self.output_shape, grid.lin.shape[1]))
            if intermediates is not None and counts is not None:
                intermediates["sparse_active_counts"] = counts
        dense, mask = None, None
        li = 0
        # the ops from wide_from to the last sparse one
        with contextlib.ExitStack() as wide:
            for scale_idx, group in enumerate(_group_topology(self.topology)):
                if (self.dense_from_scale is not None
                        and scale_idx >= self.dense_from_scale):
                    if dense is None:
                        dense = sparse.to_dense(grid)
                        ones = grid.features.new_ones(grid.lin.shape + (1,))
                        mask = sparse.to_dense(
                            grid._replace(features=ones))[:, 0] > 0
                    dense, mask = self._dense_group(group, dense, mask, li)
                    li += len(group)
                    continue
                out_grid, down_slots = None, None
                if group[-1][0] == "down":
                    _, _, kernel, stride, pad = group[-1]
                    out_shape = _down_out_shape(
                        grid.shape, _t3(kernel), _t3(stride), _t3(pad))
                    out_grid = sparse.from_sorted_voxel_coords(
                        None, plan[f"plan_coords{scale_idx}"], out_shape)
                    down_slots = plan[f"plan_conv{scale_idx}"]
                for op in group:
                    if li == self.wide_from:
                        wide.enter_context(timer.span("net.middle.wide"))
                    if op[0] == "block":
                        grid = getattr(self, f"block{li}")(
                            grid, plan[f"plan_subm{scale_idx}"])
                        li += 1
                        continue
                    w, b = self._weight(op, li), self._bias(op, li)
                    if op[0] == "subm":
                        grid = sparse.subm_conv(
                            grid, plan[f"plan_subm{scale_idx}"], w, b)
                    else:
                        grid = sparse.sparse_conv_apply(
                            grid, out_grid, down_slots, w, b)
                    feats = self._norm_relu(grid.features, li, grid.valid, -1)
                    feats = torch.where(grid.valid[..., None], feats,
                                        torch.zeros_like(feats))
                    grid = grid._replace(features=feats)
                    li += 1
        if dense is None:
            dense = sparse.to_dense(grid)
        b, c, d, h, w_ = dense.shape
        return dense.reshape(b, c * d, h, w_)

    def _dense_group(self, group, feats, mask, li):
        """One scale's ops as masked dense conv3d. feats [B, C, D, H, W],
        mask bool [B, D, H, W] (the active set)."""
        for op in group:
            kernel = _t3(op[2])
            if op[0] == "subm":
                stride = (1, 1, 1)
                pad = tuple((k - 1) // 2 for k in kernel)
            else:
                stride, pad = _t3(op[3]), _t3(op[4])
            w = self._weight(op, li)
            k, cin, cout = w.shape
            w3 = w.reshape(*kernel, cin, cout).permute(4, 3, 0, 1, 2)
            out = F.conv3d(feats, w3, stride=stride, padding=pad)
            if not self.use_norm:
                out = out + self._bias(op, li).view(1, -1, 1, 1, 1)
            if op[0] == "down":
                # the dilated active set: any output whose window
                # touches an active input
                ones = mask.new_ones((1, 1) + kernel, dtype=torch.float32)
                mask = F.conv3d(mask[:, None].float(), ones,
                                stride=stride, padding=pad)[:, 0] > 0.5
            out = self._norm_relu(out, li, mask, 1)
            feats = torch.where(mask[:, None], out, torch.zeros_like(out))
            li += 1
        return feats, mask


@register_middle
class SpMiddleFHD(SparseMiddleBase):
    """The SECOND FHD middle: 4 downsample stages [41, 1600, 1408] ->
    [2, 200, 176], channels 16 -> 32 -> 64; scale 3 as the dense tail."""

    topology = FHD_TOPOLOGY
    dense_from_scale = 3


@register_middle
class SpMiddleFHDPeople(SparseMiddleBase):
    """3-stage variant for pedestrian and cyclist grids."""

    topology = FHD_PEOPLE_TOPOLOGY
    capacity_factors = (3.25, 1.1, 1.0)


@register_middle
class SpMiddleFHDLite(SparseMiddleBase):
    """Downsample-only lite variant."""

    topology = FHD_LITE_TOPOLOGY


@register_middle
class SpMiddleFHDLiteHRZ(SparseMiddleBase):
    """Downsample-only, for a taller z grid."""

    topology = FHD_LITE_HRZ_TOPOLOGY
    capacity_factors = (3.25, 1.05, 0.6, 0.95, 0.95)


@register_middle
class SpMiddleFHDHRZ(SparseMiddleBase):
    """FHD with 5 downsample stages, for a taller z grid."""

    topology = FHD_HRZ_TOPOLOGY
    capacity_factors = (3.25, 1.05, 0.6, 0.95, 0.95)


@register_middle
class SpMiddle2K(SparseMiddleBase):
    """2k-resolution middle with an 8-channel full-resolution stage."""

    topology = MIDDLE_2K_TOPOLOGY
    capacity_factors = (3.25, 1.1, 1.1, 0.7, 0.9)


@register_middle
class SpMiddleResNetFHD(SparseMiddleBase):
    """The residual middle of nuScenes' voxel detectors (OpenPCDet's
    ``VoxelResBackBone8x``, det3d's ``SpMiddleResNetFHD``) on a
    [41, 1024, 1024] grid: 4 -> 16 -> 32 -> 64 -> 128 channels over 4
    downsample stages to [2, 128, 128], two residual blocks a scale,
    every conv sparse (no dense tail). The published blocks' convs carry
    a bias ahead of their norm; at inference it folds into the norm's
    shift, so these stay bias-free.

    ``capacity_factors``: the active sets of 10-sweep nuScenes frames
    (``benchmark/gen/nusc_scenes.py``) at 60 000 voxels, measured by the
    plain reference's rulebooks (PERF.md section 4), with headroom.
    """

    topology = RESNET_FHD_TOPOLOGY
    capacity_factors = (1.8, 0.465, 0.34, 0.78)


# the sparse middle family: rulebooks from the host planner (loaders) or
# the device (requests, and the loaders' device route)
SPARSE_MIDDLE_NAMES = frozenset({
    "SpMiddleFHD", "SpMiddleFHDPeople", "SpMiddleFHDLite",
    "SpMiddleFHDLiteHRZ", "SpMiddleFHDHRZ", "SpMiddle2K",
    "SpMiddleResNetFHD",
})
