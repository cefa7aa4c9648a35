"""The multi-rank dry run (twin of ``__graft_entry__.dryrun_multichip``)
and the rank bodies of the data-parallel checks.

    python -m second_tpu_torch.parallel.dryrun [--ranks 2] [--full]
        [--device cuda:0|cpu]

:func:`dryrun_multichip` spawns n ranks (gloo: sharing one named card,
``cuda:0`` by default, or on the CPU when the caller asks) that run one train step of PointPillars
(``configs/pointpillars/car/xyres_16.config``, random weights from seed
0) on n distinct scenes, the batch sharded over the ranks, then the
sharded eval step, whose detections rank 0 holds against a
single-process eval of the same state (box, score and label at 1e-3,
as the JAX dry run does). By default at the JAX dry run's shrunk range
([0, -10.24, 20.48, 10.24], 1024 voxels, ``make_scene`` frames);
``full=True`` at the published width (12000 pillars,
``make_kitti_scene`` frames).

The rank bodies live here, in an importable module, because spawned
processes import their target by name: :func:`step_rank` (one sharded
train step: global gradients, metrics and the state after it) and
:func:`entry_rank` (``train``/``evaluate`` through the entry points).
"""

import argparse
import copy
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..builders.network_builder import build_network
from ..configs import load_pipeline_config
from ..data.synthetic import assemble_example, make_kitti_scene, make_scene
from ..models.voxelnet import init_weights
from ..ops import launch_counts
from ..train import optimizer as opt_builder
from ..train.state import (
    loss_and_global_grads,
    make_eval_step,
    make_train_step,
    make_voxelizer_fn,
)
from ..utils.config_tool import change_detection_range
from . import mesh

CONFIG = (Path(__file__).resolve().parents[2] / "configs" / "pointpillars"
          / "car" / "xyres_16.config")
SHRUNK_RANGE = [0.0, -10.24, 20.48, 10.24]
# the JAX dry run's tolerance on the sharded eval's detections
DETS_TOL = 1e-3
DET_KEYS = ("box3d_lidar", "scores", "label_preds")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_outputs(net, spec, cfg, example, voxelizer=None, float64=False):
    """One train step of ``make_train_step`` (the optimizer of ``cfg``) on
    ``example``, this rank's shard under a group: returns the global
    gradients of a copy of ``net`` before the step (the step returns
    none), by name on the CPU, also from a float64 copy with
    ``float64``; the step's metrics (floats, and the classification
    counts as int arrays); and its ms, synchronised."""
    def grads_of(model, ex):
        params = list(model.parameters())
        _, grads = loss_and_global_grads(model, spec, ex, params, voxelizer)
        names = [n for n, _ in model.named_parameters()]
        return {n: g.detach().cpu() for n, g in zip(names, grads)}

    out = {"grads": grads_of(copy.deepcopy(net), example)}
    if float64:
        ex64 = {k: v.double() if v.is_floating_point() else v
                for k, v in example.items()}
        out["grads64"] = grads_of(copy.deepcopy(net).double(), ex64)
    opt, lr_fn, mom_fn = opt_builder.build(
        cfg.train_config.optimizer, cfg.train_config.steps,
        list(net.parameters()))
    step = make_train_step(net, spec, opt, lr_fn, mom_fn,
                           voxelizer=voxelizer)
    device = next(net.parameters()).device
    _sync(device)
    t0 = time.perf_counter()
    metrics = step(example)
    _sync(device)
    out["ms"] = (time.perf_counter() - t0) * 1e3
    stats = metrics.pop("cls_stats")
    out["metrics"] = {k: float(v) for k, v in metrics.items()
                      if k != "sparse_active_counts"}
    out["cls_stats"] = {k: v.cpu().numpy() for k, v in stats.items()}
    return out


def _voxelizer(cfg, parts, example):
    if "points" not in example:
        return None
    return make_voxelizer_fn(
        parts["voxel_generator"],
        cfg.train_input_reader.preprocess.max_number_of_voxels)


def step_rank(rank, world_size, init_method, device, backend, config_path,
              batch_path, weights_path, out_path, float64=False):
    """Rank body: this rank's shard (``put_sharded``) of the global host
    batch pickled at ``batch_path`` through :func:`step_outputs`, on the
    network of ``config_path`` with the state dict at ``weights_path``.
    Writes the outputs and the state after the step (CPU tensors) to
    ``out_path`` with the rank's number appended; returns that path, the
    step's ms and the rank's kernel launches."""
    device = mesh.make_mesh(device, backend, init_method, rank, world_size)
    cfg = load_pipeline_config(config_path)
    parts = build_network(cfg, device)
    net = parts["net"]
    net.load_state_dict(torch.load(weights_path, map_location=device,
                                   weights_only=True))
    with open(batch_path, "rb") as f:
        example = mesh.put_sharded(pickle.load(f), device)
    out = step_outputs(net, parts["spec"], cfg, example,
                       _voxelizer(cfg, parts, example), float64)
    out["state"] = {k: v.cpu() for k, v in net.state_dict().items()}
    path = f"{out_path}.rank{rank}"
    torch.save(out, path)
    return {"path": path, "ms": out["ms"], "launches": launch_counts()}


def entry_rank(rank, world_size, init_method, device, backend, calls):
    """Rank body: ``calls``, a list of ("train" | "evaluate", kwargs), run
    in order through ``train.__main__`` with this rank's device and the
    group's backend (``train`` itself checks that the ranks' states
    agree at its end). Returns the rank's kernel launches after each
    call, and each ``evaluate``'s result on rank 0."""
    from ..train.__main__ import evaluate, train

    entries = {"train": train, "evaluate": evaluate}
    device = mesh.make_mesh(device, backend, init_method, rank, world_size)
    out = []
    for name, kwargs in calls:
        res = entries[name](device=device, dist_backend=backend, **kwargs)
        out.append({"launches": launch_counts(),
                    "result": res if name == "evaluate" else None})
    return out


def dryrun_parts(full, device):
    """The dry run's config and network (random weights, seed 0)."""
    cfg = load_pipeline_config(str(CONFIG))
    if not full:
        change_detection_range(cfg.model.second, SHRUNK_RANGE)
    parts = build_network(cfg, device)
    init_weights(parts["net"], torch.Generator().manual_seed(0))
    return cfg, parts


def dryrun_batch(parts, n, full):
    """The JAX dry run's batch of ``n`` distinct scenes (seeds 0..n-1)."""
    if full:
        scenes = [make_kitti_scene(np.random.RandomState(i))
                  for i in range(n)]
        return assemble_example(parts, scenes, max_voxels=12000)
    scenes = [make_scene(np.random.RandomState(i), num_objects=3,
                         num_bg_points=2000, x_range=(0.0, 20.48),
                         y_range=(-10.24, 10.24)) for i in range(n)]
    return assemble_example(parts, scenes, max_voxels=1024)


def _dets_numpy(dets):
    return {k: dets[k].cpu().numpy() for k in DET_KEYS}


def _dryrun_rank(rank, world_size, init_method, full, device):
    device = mesh.make_mesh(device, "gloo", init_method, rank, world_size)
    cfg, parts = dryrun_parts(full, device)
    net, spec = parts["net"], parts["spec"]
    host = dryrun_batch(parts, world_size, full)
    example = mesh.put_sharded(host, device)
    opt, lr_fn, mom_fn = opt_builder.build(
        cfg.train_config.optimizer, 10, list(net.parameters()))
    metrics = make_train_step(net, spec, opt, lr_fn, mom_fn)(example)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {loss}")
    eval_step = make_eval_step(net, spec)
    per_rank = mesh.gather_to_rank0(_dets_numpy(eval_step(example)))
    out = {"loss": loss, "launches": launch_counts(),
           "digest": mesh.state_digest(net)}
    if rank != 0:
        return out
    sharded = {k: np.concatenate([d[k] for d in per_rank])
               for k in DET_KEYS}
    full_batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    single = _dets_numpy(eval_step(full_batch))
    for key in DET_KEYS:
        a, b = sharded[key], single[key]
        if a.shape != b.shape:
            raise RuntimeError(f"dryrun_multichip: {key} {a.shape} sharded, "
                               f"{b.shape} single")
        np.testing.assert_allclose(
            a.astype(np.float32), b.astype(np.float32), rtol=DETS_TOL,
            atol=DETS_TOL, err_msg=key)
    out["num_det"] = int((sharded["scores"] > 0).sum())
    out["max_err"] = {k: float(np.abs(sharded[k].astype(np.float64)
                                      - single[k]).max()) for k in DET_KEYS}
    return out


def dryrun_multichip(n_devices, full=False, device="cuda:0", timeout=900.0):
    """Spawn ``n_devices`` gloo ranks on ``device`` (one named card that
    they share, or the CPU), run one sharded train step and check the
    sharded eval against the single-process eval (see the module's
    docstring). Returns rank 0's result with every rank's kernel
    launches summed; raises on any failure, a rank's included, and when
    ``device`` is a card and there is none."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"dryrun_multichip: device {device} asked for, "
                           f"but no CUDA device (pass device='cpu')")
    results = mesh.run_ranks(_dryrun_rank, n_devices,
                             args=(full, device), timeout=timeout)
    if len({r["digest"] for r in results}) != 1:
        raise RuntimeError("dryrun_multichip: the ranks' states differ "
                           "after the step")
    out = dict(results[0])
    out.pop("digest")
    out["launches"] = {k: sum(r["launches"][k] for r in results)
                       for k in results[0]["launches"]}
    shape = "full" if full else "shrunk"
    print(f"dryrun_multichip({n_devices}): one sharded train step ok "
          f"({shape} shapes, B={n_devices}, device {device}), loss="
          f"{out['loss']:.4f}; sharded eval/predict matches single-process "
          f"({out['num_det']} scored detections, max error "
          f"{out['max_err']})")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    dryrun_multichip(args.ranks, full=args.full, device=args.device)


if __name__ == "__main__":
    main()
