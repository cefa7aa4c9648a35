"""JAX package variables -> the port's ``state_dict``.

Inverts the layout table of ``second_tpu/utils/checkpoint_import.py``
(which maps upstream torch checkpoints onto flax variables):

  * flax Conv HWIO           -> torch Conv2d OIHW
  * flax ConvTranspose HWIO  -> torch ConvTranspose2d IOHW, spatially
                                flipped (flax does not flip the kernel)
  * flax Dense [in, out]     -> torch Linear [out, in]
  * sparse conv [K, Cin, Cout] (``*_w``) unchanged
  * MaskedBatchNorm scale/bias + batch_stats mean/var
                             -> weight/bias + running_mean/running_var

  * GroupNorm scale/bias       -> weight/bias

Module names map one to one (the port keeps the flax names), except
flax's auto-named children: ``ConvBNReLU_{n}`` -> ``layers.{n}``,
``PFNLayer_{n}`` -> ``pfn_layers.{n}``, ``VFELayer_{n}`` ->
``vfe_layers.{n}``, ``BasicBlock_{n}`` -> ``blocks.{n}``,
``Conv_0``/``ConvTranspose_0`` -> ``conv``, ``MaskedBatchNorm_0`` ->
``bn``, ``GroupNorm_0`` -> ``gn``, ``Dense_0`` -> ``linear``,
``LinearBNReLU_0`` -> ``linear_bn_relu``; inside a ``BasicBlock_{n}``,
``Conv_{0,1}``/``MaskedBatchNorm_{0,1}`` -> ``conv1``/``bn1``,
``conv2``/``bn2`` and the shortcut's ``Conv_2``/``MaskedBatchNorm_2``
-> ``downsample_conv``/``downsample_bn``.
"""

import re

import numpy as np
import torch

_CHILD = {"Conv_0": "conv", "ConvTranspose_0": "conv",
          "MaskedBatchNorm_0": "bn", "GroupNorm_0": "gn", "Dense_0": "linear",
          "LinearBNReLU_0": "linear_bn_relu"}
# the children of a BasicBlock_{n}
_BLOCK_CHILD = {"Conv_0": "conv1", "MaskedBatchNorm_0": "bn1",
                "Conv_1": "conv2", "MaskedBatchNorm_1": "bn2",
                "Conv_2": "downsample_conv",
                "MaskedBatchNorm_2": "downsample_bn"}
# flax's auto-named lists of children -> the port's ModuleLists
_LISTS = {"ConvBNReLU": "layers", "PFNLayer": "pfn_layers",
          "VFELayer": "vfe_layers", "BasicBlock": "blocks"}
_LIST_RE = re.compile(r"(%s)_(\d+)" % "|".join(_LISTS))
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(path):
    out = []
    for i, part in enumerate(path):
        m = _LIST_RE.fullmatch(part)
        if m:
            out.append(f"{_LISTS[m.group(1)]}.{m.group(2)}")
        elif i > 0 and path[i - 1].startswith("BasicBlock_"):
            out.append(_BLOCK_CHILD[part])
        else:
            out.append(_CHILD.get(part, part))
    return ".".join(out)


def _convert_param(path, value):
    *mods, leaf = path
    value = np.asarray(value, dtype=np.float32)
    if leaf == "kernel":
        if mods and mods[-1] == "ConvTranspose_0":
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)  # -> IOHW
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif value.ndim == 2:
            value = value.T  # Dense [in, out] -> Linear [out, in]
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return _module_path(mods), leaf, value


def from_flax(variables):
    """{"params": tree, "batch_stats": tree} of arrays -> state_dict of
    CPU float32 tensors for :class:`second_tpu_torch.models.voxelnet.VoxelNet`
    (load with ``load_state_dict(..., strict=True)``)."""
    state = {}
    for path, value in _flatten(variables["params"]):
        mod, leaf, value = _convert_param(path, value)
        # a fresh C-order copy: flipped views of size-1 axes can keep
        # negative strides, which torch.from_numpy refuses
        state[_key(mod, leaf)] = torch.from_numpy(np.array(value, order="C"))
    for path, value in _flatten(variables.get("batch_stats", {})):
        *mods, leaf = path
        state[_key(_module_path(mods), _STATS[leaf])] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C"))
    return state


def _key(mod, leaf):
    return f"{mod}.{leaf}" if mod else leaf
