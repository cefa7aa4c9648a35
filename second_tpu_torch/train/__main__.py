"""Train / evaluate entry points (twin of ``second_tpu/train/__main__.py``;
the reference's second/pytorch/train.py CLI surface).

    python -m second_tpu_torch.train train --config_path=X --model_dir=Y
    python -m second_tpu_torch.train evaluate --config_path=X --model_dir=Y

Both run on ``cuda`` unless given ``--device=cpu``. Without a process
group the batch is the reader's, on one device. Checkpoints keep the
upstream JSON-manifest layout (``train/checkpoint.py``); the config is
snapshotted into model_dir as pipeline.config.

Data parallelism (the JAX package's mesh over every device): launched
by ``torchrun`` (or in a process that already joined a group), each
process is a rank (``parallel.make_mesh``: NCCL on ``cuda:LOCAL_RANK``,
gloo on the CPU; ``--dist_backend=gloo --device=cuda:0`` lets ranks
share one card):

    torchrun --nproc_per_node=N -m second_tpu_torch.train train \
        --config_path=X --model_dir=Y [--dist_backend=nccl|gloo]

The reader's batch is the global one, trimmed to a multiple of the
world size as in the JAX package; every rank shuffles with one seed
that rank 0 broadcasts, takes its contiguous slice of each global batch
and augments from its own stream of (seed, rank). The step computes the
global batch's loss, gradients and batch statistics
(``train.state.make_train_step``), so the ranks' states stay equal.
Only rank 0 writes the log, pipeline.config, checkpoints, results and
the profile; every rank restores. The evals split the frames over the
ranks and gather the detections on rank 0, which computes the AP.

``device_voxelize`` picks what the loader ships (its route,
``builders.route.make_route``). "auto" (the default): for dense middles
(PointPillars) the in-range points and compact targets, the step
voxelizing on the device and the eval running the flat pillar path;
for sparse middles (car.fhd) the host voxels and the host planner's
``plan_*`` rulebooks. True ships points for sparse middles too: the
step voxelizes and builds every rulebook on the device
(``--device_voxelize=True``). False ships host voxels for every middle.
Neither route falls back to the other. For sparse middles the loop logs
the stages' utilisation (``sparse_util_max``, with a warning when a
stage dropped voxels), from the host plan's counts or the step's device
counts, read at display steps. A training reader that names a
GT-database sampler trains with it. ``use_banded`` and
``quantize_points`` raise ``NotImplementedError`` (ROADMAP.md "Raising
by design").

Fine-tuning follows the JAX package's order: restore the latest
checkpoint (or start from seed 0), then copy ``pretrained_path``'s
parameters (after a resume too, so they overwrite the resumed ones),
then freeze: ``freeze_include``/``freeze_exclude`` (regexes on the flax
parameter paths, ``utils.from_flax.flax_path``) rebuild the optimizer
over the other parameters, fresh. ``profile_steps`` > 0 writes a
``torch.profiler`` trace of that many steps, from the second step of the
run, under ``model_dir/profile``. An optimizer with
``use_moving_average`` keeps an EMA of the parameters, and the evals of
``train`` and ``evaluate`` run on it (the batch statistics stay live),
except under a freeze, where the JAX package finds no EMA in its
optimizer state and evaluates the live parameters.

A nuScenes reader (``NuScenesDataset`` and its variants) evaluates
through the dataset's ``evaluation``: the official nuScenes metrics
where the devkit is installed, else the kitti-style AP of its classes
("kitti.official"), as in the JAX package.

``train_config.enable_mixed_precision`` runs the network in bf16
(``build_network``): PointPillars trains so, its parameters, gradients,
AdamW state and checkpoints f32; a sparse middle's ``train`` raises
``NotImplementedError`` before its first step (the JAX package cannot
train one in bf16), while ``evaluate`` runs it in bf16.
"""

import json
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from ..builders import dataset_builder
from ..builders.network_builder import build_network
from ..builders.route import make_route
from ..configs import load_pipeline_config
from ..core.inference import example_convert, to_tensor
from ..data.loader import DataLoader, shard_batches
from ..data.prefetch import DevicePrefetcher
from ..models.voxelnet import init_weights
from ..parallel import mesh
from ..utils.log_tool import SimpleModelLog
from ..utils.metrics import RunningMetrics
from ..utils.timer import ModelTimer
from . import checkpoint as ckpt_lib
from . import optimizer as opt_builder
from .state import (
    TrainState,
    make_eval_step,
    make_train_step,
    refuse_bf16_sparse_training,
)


def _unported(**options):
    """Raise for the first option that is set: none is ignored."""
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{name}={value!r} is outside second_tpu_torch (ROADMAP.md: "
                f"use_banded and quantize_points are 'Raising by design')")


def _upload(host, device):
    """Host arrays -> tensors on ``device``; on CUDA through pinned host
    memory with non-blocking copies, so the copy of the next batch
    overlaps the running step."""
    if device.type != "cuda":
        return {k: to_tensor(v, device) for k, v in host.items()}
    return {k: to_tensor(v, "cpu").pin_memory().to(device, non_blocking=True)
            for k, v in host.items()}


def _new_state(cfg, parts):
    """Random weights (seed 0) and a fresh optimizer."""
    net = parts["net"]
    init_weights(net, torch.Generator().manual_seed(0))
    train_cfg = cfg.train_config
    opt, lr_fn, mom_fn = opt_builder.build(
        train_cfg.optimizer, train_cfg.steps, list(net.parameters()))
    return opt, lr_fn, mom_fn


def _restore_or_init(model_dir, state):
    """Continue from the latest checkpoint of ``model_dir``, if any."""
    state, step = ckpt_lib.try_restore_latest(model_dir, "voxelnet", state)
    if step is not None:
        print(f"Restored checkpoint at step {step}")
    return state


def _join_group(device, dist_backend):
    """This process's device: the rank's (``parallel.make_mesh``) under a
    launcher or a group this process already joined, else ``device``."""
    if mesh.launched():
        return mesh.make_mesh(device, dist_backend)
    if dist_backend is not None:
        raise ValueError(f"dist_backend={dist_backend!r} without a process "
                         f"group: launch the ranks with torchrun")
    return torch.device(device)


def _global_batch(batch_size):
    """``batch_size`` trimmed to a multiple of the world size, as the JAX
    package trims it to its device count."""
    w = mesh.world()
    if batch_size % w != 0:
        batch_size = max(w, batch_size - batch_size % w)
        print(f"adjusted batch_size to {batch_size} for {w} devices")
    return batch_size


class _SilentLog:
    """The log of a rank other than 0: rank 0 writes the run's one log."""

    def log_text(self, text, step):
        pass

    def log_metrics(self, metrics, step):
        pass

    def close(self):
        pass


class _Profile:
    """The JAX package's ``profile_steps`` window as a ``torch.profiler``
    trace: it starts before the run's second step and stops after
    ``steps`` steps, writing ``model_dir/profile/trace.json`` (Chrome
    trace format: the host's ops and, on CUDA, the card's kernels)."""

    def __init__(self, model_dir, steps, start_step, device):
        self.dir = Path(model_dir) / "profile"
        self.steps = steps
        self.start, self.stop = start_step + 1, start_step + 1 + steps
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = None

    def before(self, step):
        if self.steps > 0 and step == self.start:
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.start()

    def after(self, step, log):
        if self.prof is not None and step == self.stop:
            self.close()
            log.log_text(f"profiler trace written to {self.dir}", step)

    def close(self):
        """Stop a trace still running and write it out."""
        if self.prof is None:
            return
        self.prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.dir / "trace.json"))
        self.prof = None


def train(config_path,
          model_dir,
          result_path=None,
          resume=False,
          display_step=50,
          pretrained_path=None,
          pretrained_include=None,
          pretrained_exclude=None,
          freeze_include=None,
          freeze_exclude=None,
          measure_time=False,
          profile_steps=0,
          batch_size=None,
          num_workers=None,
          loader_mode="auto",
          device_voxelize="auto",
          quantize_points=False,
          use_banded=False,
          device="cuda",
          dist_backend=None):
    """Train a detector with the given pipeline config.

    device_voxelize "auto" ships, for dense middles (the PointPillars
    family), each frame's in-range points (the reader's
    ``builders.route.points_capacity`` rows) and compact targets: the
    step voxelizes on the device (``builders.route.make_voxelizer_fn``)
    and rebuilds the dense targets there, and the eval runs the flat
    pillar path; for sparse middles (car.fhd) the host voxels and
    rulebooks, uploaded like the rest (pinned, non-blocking, one thread
    ahead). True ships points for sparse middles as well (the JAX
    package's route without its planner): the step voxelizes and builds
    the rulebooks on the device. False ships host voxels. The eval runs
    the network's modules and ``predict`` outside the flat pillar path;
    it (every ``steps_per_eval`` steps and at the end) reports the
    official KITTI AP into log.txt.

    loader_mode: "auto" picks the loader's threads on CUDA: a forked
    worker is safe after CUDA is initialised only while it never touches
    CUDA, and threads need no such promise. On the CPU "auto" forks a
    pool when ``num_workers`` > 0, as the JAX package does.

    dist_backend: the process group's backend under a launcher (see the
    module's docstring); None picks NCCL on CUDA and gloo on the CPU.
    """
    _unported(quantize_points=quantize_points, use_banded=use_banded)
    device = _join_group(device, dist_backend)
    lead = mesh.rank() == 0
    model_dir = Path(model_dir)
    if model_dir.exists() and not resume and (
            model_dir / "checkpoints.json").exists():
        raise ValueError(
            f"model dir {model_dir} exists and resume=False")
    seed = None
    if mesh.launched():
        # one permutation for every rank, its own augmentation stream
        seed = mesh.broadcast_object(int(np.random.randint(2**31)))
        np.random.seed(np.random.SeedSequence(
            (seed, mesh.rank())).generate_state(1)[0])
    cfg = load_pipeline_config(config_path)
    parts = build_network(cfg, device)
    refuse_bf16_sparse_training(parts["net"])
    if lead:
        model_dir.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(config_path, model_dir / "pipeline.config")
    mesh.barrier()
    if result_path is None:
        result_path = model_dir / "results"
    net, spec = parts["net"], parts["spec"]
    train_cfg = cfg.train_config

    # the evals ship what training ships
    route = make_route(parts, cfg.train_input_reader, "train",
                       device_voxelize)
    eval_route = make_route(parts, cfg.eval_input_reader, "eval",
                            route.ships_points)
    dataset = dataset_builder.build(
        cfg.train_input_reader, parts, training=True,
        device_voxelize=route.ships_points)
    eval_dataset = dataset_builder.build(
        cfg.eval_input_reader, parts, training=False,
        device_voxelize=route.ships_points)

    batch_size = _global_batch(
        batch_size or cfg.train_input_reader.batch_size)
    num_workers = (
        num_workers
        if num_workers is not None
        else cfg.train_input_reader.preprocess.num_workers)
    total_step = train_cfg.steps
    opt, lr_fn, mom_fn = _new_state(cfg, parts)
    if loader_mode == "auto":
        loader_mode = ("process" if device.type == "cpu" and num_workers
                       else "thread")
    loader = DataLoader(
        dataset, batch_size, shuffle=True, num_workers=num_workers,
        mode=loader_mode, seed=seed, rank=mesh.rank(),
        world_size=mesh.world())

    log = SimpleModelLog(model_dir).open() if lead else _SilentLog()
    log.log_text(
        f"second_tpu_torch train: {len(dataset)} frames, batch={batch_size}, "
        f"device={device}, steps={total_step}"
        + (f", ranks={mesh.world()}" if mesh.launched() else ""), 0)

    state = _restore_or_init(model_dir, TrainState(net, opt))
    if pretrained_path is not None:
        ckpt_lib.restore_pretrained(pretrained_path, net,
                                    include=pretrained_include,
                                    exclude=pretrained_exclude)
    if freeze_include is not None or freeze_exclude is not None:
        state.optimizer, lr_fn, mom_fn = opt_builder.freeze_by_patterns(
            train_cfg.optimizer, total_step, net, include=freeze_include,
            exclude=freeze_exclude)
    step_fn = make_train_step(net, spec, state.optimizer, lr_fn, mom_fn,
                              route=route)
    step_fn.state.global_step = state.global_step
    state = step_fn.state
    eval_step = make_eval_step(net, spec, route=eval_route)

    timer = ModelTimer(enabled=measure_time)
    running = RunningMetrics()
    steps_per_epoch = max(len(loader), 1)
    step = start_step = state.global_step
    profile = _Profile(model_dir, profile_steps if lead else 0,
                       start_step, device)
    last_ckpt_time = time.time()
    t_step = time.time()
    anchors_dev = None
    # the sparse stages' (true active, capacity) counts of the steps
    # since the last log: the host plan's arrays or the step's device
    # tensors, read at the display step
    pending_counts = []

    def _prep(example):
        # anchors are the run-constant anchor cache repeated per example:
        # upload them once and splice the resident tensor into every
        # batch instead of re-shipping ~3 MB per step
        nonlocal anchors_dev
        host = example_convert(example)
        anchors = host.pop("anchors")
        if anchors_dev is None:
            anchors_dev = to_tensor(anchors, device)
        if "importance" in host and np.all(host["importance"] == 1.0):
            host.pop("importance")  # compute_loss defaults to ones
        dev = _upload(host, device)
        dev["anchors"] = anchors_dev
        # the sparse stages' (true_active, capacity) stay on the host
        return dev, example.get("sparse_active_counts")

    def _timed(iterable):
        it = iter(iterable)
        while True:
            timer.start("data_fetch")
            try:
                nxt = next(it)
            except StopIteration:
                return
            timer.end("data_fetch")
            yield nxt

    def _eval(tag):
        res = _run_eval(eval_step, eval_dataset, batch_size, num_workers,
                        Path(result_path) / tag, device, state.optimizer,
                        log=log, step=step)
        if res is not None:
            for name, text in res["results"].items():
                log.log_text(f"Evaluation {name}", step)
                log.log_text(text, step)

    try:
        while step < total_step:
            # convert + H2D of the next batches overlaps the device step
            for ex, active in _timed(DevicePrefetcher(loader, _prep)):
                if step >= total_step:
                    break
                profile.before(step)
                timer.start("train_step")
                metrics = step_fn(ex)
                timer.end("train_step", sync=True)
                step += 1
                profile.after(step, log)
                running.update(metrics.pop("cls_stats"))
                active = metrics.pop("sparse_active_counts", active)
                if active is not None:
                    pending_counts.append(active)
                if step % display_step == 0 or step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(running.value())
                    if pending_counts:
                        m["sparse_util_max"] = _sparse_utilisation(
                            np.concatenate([np.asarray(
                                c.cpu() if torch.is_tensor(c) else c)
                                for c in pending_counts]), log, step)
                        pending_counts.clear()
                    m["steps_per_sec"] = display_step / max(
                        time.time() - t_step, 1e-6)
                    t_step = time.time()
                    log.log_metrics({"runtime": m}, step)
                    if measure_time:
                        avg = timer.get_avg_time_dict()
                        log.log_text(
                            "avg_time_ms: " + ", ".join(
                                f"{k}={v * 1000:.3f}"
                                for k, v in avg.items()), step)
                        timer.clear()
                if train_cfg.clear_metrics_every_epoch and \
                        step % steps_per_epoch == 0:
                    running.clear()
                if time.time() - last_ckpt_time > \
                        train_cfg.save_checkpoints_secs:
                    ckpt_lib.save(model_dir, state, "voxelnet", step)
                    last_ckpt_time = time.time()
                if train_cfg.steps_per_eval > 0 and \
                        step % train_cfg.steps_per_eval == 0:
                    ckpt_lib.save(model_dir, state, "voxelnet", step)
                    _eval(f"step_{step}")
    except Exception:
        ckpt_lib.save(model_dir, state, "voxelnet", step)
        raise
    finally:
        profile.close()
        timer.close()
    mesh.assert_replicated(net)
    ckpt_lib.save(model_dir, state, "voxelnet", step)
    mesh.barrier()
    _eval("final")
    log.close()
    return str(model_dir)


def _sparse_utilisation(active, log, step):
    """The largest share of its capacity that a sparse stage's true
    active set takes in these examples (``active``: [N, S, 2] of
    (true_active, capacity)), with a warning in the log when a stage
    took more: the static capacities dropped voxels there."""
    util = active[..., 0] / np.maximum(active[..., 1], 1)
    if util.max() > 1.0:
        log.log_text(
            f"WARNING sparse active-set OVERFLOW: per-stage utilization "
            f"{util.max(axis=0).round(3).tolist()} - voxels dropped; raise "
            f"capacity_factors", step)
    return float(util.max())


def _run_eval(eval_step, eval_dataset, batch_size, num_workers, result_dir,
              device, optimizer, timer=None, log=None, step=0):
    """Eval loop: fixed-shape batches, ragged detections, official AP;
    on the parameter EMA where ``optimizer`` keeps one
    (``optimizer.ema_weights``; reference train.py:433-481 restores the
    moving-average variables for eval). Under a process group each rank
    runs its slice of every global batch of ``batch_size`` and rank 0
    gathers the detections, writes them and computes the AP; the other
    ranks return None."""
    with opt_builder.ema_weights(optimizer):
        return _eval_loop(eval_step, eval_dataset, batch_size, num_workers,
                          result_dir, device, timer, log, step)


def _eval_loop(eval_step, eval_dataset, batch_size, num_workers, result_dir,
               device, timer, log, step):
    timer = timer or ModelTimer(enabled=False)
    loader = DataLoader(
        eval_dataset, batch_size, shuffle=False,
        num_workers=num_workers, drop_last=False, rank=mesh.rank(),
        world_size=mesh.world())
    local_batch = batch_size // mesh.world()
    detections = []
    t0 = time.time()

    def _drain(pending):
        """Device->host copy of a finished batch (the sync)."""
        dets_dev, real, metadata = pending
        dets = {k: v.cpu().numpy() for k, v in dets_dev.items()}
        for b in range(real):
            valid = dets["valid"][b]
            detections.append({
                "box3d_lidar": dets["box3d_lidar"][b][valid],
                "scores": dets["scores"][b][valid],
                "label_preds": dets["label_preds"][b][valid],
                "metadata": metadata[b],
            })

    # double-buffered: batch N runs on the device while batch N-1's
    # detections copy to the host
    pending = None
    for example in loader:
        with timer.scope("host_prep"):
            ex_np = example_convert(example)
            real = next(iter(ex_np.values())).shape[0]
            if real < local_batch:  # pad the tail batch
                pad = local_batch - real
                ex_np = {
                    k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                    for k, v in ex_np.items()
                }
            ex = _upload(ex_np, device)
        with timer.scope("eval_step", sync=True):
            dets_dev = eval_step(ex)
            if pending is not None:
                _drain(pending)
            pending = (dets_dev, real, example["metadata"])
    if pending is not None:
        with timer.scope("eval_step"):
            _drain(pending)
    per_rank = mesh.gather_to_rank0(detections)
    if mesh.rank() != 0:
        return None
    detections = _in_dataset_order(per_rank, len(eval_dataset), batch_size)
    dt = time.time() - t0
    n = len(detections)
    msg = f"eval: {n} frames in {dt:.3f}s ({n / max(dt, 1e-9):.3f} fps)"
    if log is not None:
        log.log_text(msg, step)
    else:
        print(msg)
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    with open(result_dir / "result.pkl", "wb") as f:
        pickle.dump(detections, f)
    return eval_dataset.evaluation(detections, str(result_dir))


def _in_dataset_order(per_rank, n, batch_size):
    """The ranks' detections (each rank's in its own order) in the
    dataset's order of ``n`` frames: rank r ran its slices
    (``data.loader.shard_batches``) of the global batches."""
    w = len(per_rank)
    if w == 1:
        return per_rank[0]
    out = [None] * n
    for r, dets in enumerate(per_rank):
        idx = np.concatenate(shard_batches(np.arange(n), batch_size, False,
                                           r, w))
        if len(idx) != len(dets):
            raise RuntimeError(f"rank {r} returned {len(dets)} frames, its "
                               f"slices hold {len(idx)}")
        for i, d in zip(idx, dets):
            out[i] = d
    return out


def evaluate(config_path,
             model_dir,
             result_path=None,
             ckpt_path=None,
             measure_time=False,
             batch_size=None,
             num_workers=None,
             device_voxelize="auto",
             use_banded=False,
             device="cuda",
             dist_backend=None):
    """Evaluate the latest (or given) checkpoint with the official AP.

    device_voxelize "auto": PillarFeatureNet networks on dense middles
    ship points and run the flat pillar path; every other network runs
    its modules on the host's voxels (and a sparse middle on the host
    plan). True ships points to every network: the device voxelizes,
    and a sparse middle builds its rulebooks there. False ships host
    voxels.

    Under a process group (``train``'s docstring) every rank restores the
    checkpoint and runs its share of the frames; rank 0 returns the
    result and writes it, the other ranks return None."""
    _unported(use_banded=use_banded)
    device = _join_group(device, dist_backend)
    model_dir = Path(model_dir)
    cfg = load_pipeline_config(config_path)
    parts = build_network(cfg, device)
    net, spec = parts["net"], parts["spec"]
    route = make_route(parts, cfg.eval_input_reader, "eval", device_voxelize)
    eval_dataset = dataset_builder.build(
        cfg.eval_input_reader, parts, training=False,
        device_voxelize=route.ships_points)
    batch_size = _global_batch(
        batch_size or cfg.eval_input_reader.batch_size)
    num_workers = (
        num_workers
        if num_workers is not None
        else cfg.eval_input_reader.preprocess.num_workers)

    state = TrainState(net, _new_state(cfg, parts)[0])
    if ckpt_path is not None:
        ckpt_lib.restore(ckpt_path, state)
        step = "custom"
    else:
        state, step = ckpt_lib.try_restore_latest(
            model_dir, "voxelnet", state)
        if step is None:
            raise ValueError(f"no checkpoint found in {model_dir}")
    if result_path is None:
        result_path = model_dir / "eval_results" / f"step_{step}"
    timer = ModelTimer(enabled=measure_time)
    try:
        res = _run_eval(make_eval_step(net, spec, route=route),
                        eval_dataset, batch_size, num_workers, result_path,
                        device, state.optimizer, timer=timer)
        avg = timer.get_avg_time_dict()
    finally:
        timer.close()
    if mesh.rank() != 0:
        mesh.barrier()
        return None
    if measure_time:
        print("avg_time_ms:", {k: round(v * 1000, 3) for k, v in avg.items()})
    if res is not None:
        for name, text in res["results"].items():
            print(f"Evaluation {name}")
            print(text)
        with open(Path(result_path) / "metrics.json", "w") as f:
            json.dump(res["detail"], f, indent=2, default=str)
    mesh.barrier()
    return res


def helper_tune_target_assigner(config_path, num_tune_epoch=1,
                                classes=None):
    """Run the train pipeline standalone and report anchor-assignment
    statistics per class (reference train.py:547-640): the GT boxes of
    each class and the anchors assigned to them. No network runs, so
    there is no device."""
    cfg = load_pipeline_config(config_path)
    parts = build_network(cfg, "cpu")
    target_assigner = parts["target_assigner"]
    dataset = dataset_builder.build(cfg.train_input_reader, parts,
                                    training=True)
    class_count = {c: 0 for c in target_assigner.classes}
    anchor_count = {c: 0 for c in target_assigner.classes}
    n = len(dataset) * num_tune_epoch
    for i in range(n):
        example = dataset[i % len(dataset)]
        labels = example["labels"]
        for ci, c in enumerate(target_assigner.classes):
            class_count[c] += int(
                np.sum(np.array(example["gt_names"]) == c))
            anchor_count[c] += int(np.sum(labels == ci + 1))
    for c in target_assigner.classes:
        avg = anchor_count[c] / max(class_count[c], 1)
        print(f"{c}: {class_count[c]} gt, {anchor_count[c]} assigned "
              f"anchors ({avg:.1f} per gt)")
    return class_count, anchor_count


def main():
    from ..utils.fire_lite import fire

    try:
        fire({
            "train": train,
            "evaluate": evaluate,
            "helper_tune_target_assigner": helper_tune_target_assigner,
        })
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
