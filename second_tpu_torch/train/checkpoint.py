"""Checkpoint store with the reference's JSON-manifest layout (twin of
``second_tpu/train/checkpoint.py``).

Mirrors torchplus/train/checkpoint.py: a ``checkpoints.json`` in the
model dir maps object names to their latest file and keeps a GC'd
history (max_to_keep); filenames are ``{name}-{global_step}.ckpt``.
The payload is ``torch.save`` of the network's ``state_dict``, the
optimizer's state (moments, update count, EMA) and ``global_step``.
Writes are atomic (tmp + rename); under a process group rank 0 writes
and every rank restores. ``restore_pretrained`` loads part of
a checkpoint's parameters, chosen by the JAX package's patterns on the
flax parameter paths.
"""

import json
import os
import re
from pathlib import Path

import torch

from ..parallel import mesh
from ..utils.from_flax import flax_path


def latest_checkpoint(model_dir, name):
    info_path = Path(model_dir) / "checkpoints.json"
    if not info_path.is_file():
        return None
    with open(info_path) as f:
        info = json.load(f)
    fname = info.get("latest_ckpt", {}).get(name)
    if fname is None:
        return None
    path = Path(model_dir) / fname
    return str(path) if path.is_file() else None


def save(model_dir, state, name, global_step, max_to_keep=8):
    """Write a :class:`~second_tpu_torch.train.state.TrainState` under
    ``name`` at ``global_step``; returns the file's path. Under a process
    group only rank 0 writes (the ranks' states are equal); every rank
    gets the path."""
    model_dir = Path(model_dir)
    fname = f"{name}-{int(global_step)}.ckpt"
    if mesh.rank() != 0:
        return str(model_dir / fname)
    model_dir.mkdir(parents=True, exist_ok=True)
    info_path = model_dir / "checkpoints.json"

    tmp = model_dir / (fname + ".tmp")
    torch.save({"net": state.net.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "global_step": int(state.global_step)}, tmp)
    os.replace(tmp, model_dir / fname)

    if info_path.is_file():
        with open(info_path) as f:
            info = json.load(f)
    else:
        info = {"latest_ckpt": {}, "all_ckpts": {}}
    info["latest_ckpt"][name] = fname
    all_ckpts = [
        c for c in info["all_ckpts"].get(name, []) if (model_dir / c).is_file()
    ]
    all_ckpts.append(fname)
    while len(all_ckpts) > max_to_keep:
        stale = all_ckpts.pop(0)
        try:
            os.remove(model_dir / stale)
        except OSError:
            pass
    info["all_ckpts"][name] = all_ckpts
    tmp_info = str(info_path) + ".tmp"
    with open(tmp_info, "w") as f:
        json.dump(info, f, indent=2)
    os.replace(tmp_info, info_path)
    return str(model_dir / fname)


def restore_net(ckpt_path, net):
    """Load only the network's weights and buffers of a checkpoint into
    ``net`` (as the inference context does); returns the payload."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    net.load_state_dict(payload["net"], strict=True)
    return payload


def restore(ckpt_path, state):
    """Load a checkpoint into ``state`` (its network, optimizer and step,
    on whatever device they are); returns ``state``."""
    payload = restore_net(ckpt_path, state.net)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.global_step = int(payload["global_step"])
    return state


def try_restore_latest(model_dir, name, state):
    """Returns (state, step) or (state untouched, None) when there is
    nothing to restore."""
    path = latest_checkpoint(model_dir, name)
    if path is None:
        return state, None
    restore(path, state)
    return state, int(Path(path).stem.split("-")[-1])


def restore_pretrained(ckpt_path, net, include=None, exclude=None,
                       verbose=True):
    """Copy the shape-matching parameters of a checkpoint into ``net``
    (in place) and return their "/"-joined flax paths (twin of the JAX
    package's ``restore_pretrained``: the reference's pretrained-path
    loading, train.py:187-202).

    A checkpoint parameter is copied where ``net`` has a parameter of
    that name and shape, ``include`` (a regex on the flax path) matches
    and ``exclude`` does not (``re.match``). Only parameters: batch-norm
    running statistics stay as they are, as in the JAX package (whose
    ``restore_pretrained`` takes ``params`` alone)."""
    src = torch.load(ckpt_path, map_location="cpu", weights_only=True)["net"]
    include_re = re.compile(include) if include else None
    exclude_re = re.compile(exclude) if exclude else None
    dst = dict(net.named_parameters())
    loaded = []
    with torch.no_grad():
        for key, value in src.items():
            if key not in dst:
                continue
            path = "/".join(flax_path(key, net)[1])
            if include_re is not None and include_re.match(path) is None:
                continue
            if exclude_re is not None and exclude_re.match(path) is not None:
                continue
            if tuple(dst[key].shape) != tuple(value.shape):
                continue
            dst[key].copy_(value)
            loaded.append(path)
    if verbose:
        print(f"Restored {len(loaded)} pretrained tensors")
        for path in loaded:
            print("  ", path)
    return loaded
