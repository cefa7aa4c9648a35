"""Training throughput: ``train.state.make_train_step``'s step fed by
``data.loader.DataLoader`` through ``data.prefetch.DevicePrefetcher``,
composed and restarted per epoch as ``train()`` composes them, on a
KITTI tree the set-up writes from the seed and prepares with the port's
own ``create_data kitti_data_prep`` (infos and the GT database; the
train infos repeated so that an epoch outlasts the window). ``train()``'s
logging, checkpoints and evaluation stay out of the window.

Set-up builds the one step object (model and optimizer), drives it
through its first steps by the window's own call and feed, keeps their
batches, losses, the optimizer's first moment after step 1 and the
parameters after the last of them, and hands the same object to the
window. Once the window has closed and the port is freed, the reference
follows those steps from the same weights on the same batches.
"""

import contextlib
import pickle
import time

import numpy as np
import torch

from .. import common, flops, trace, weights
from ..gen import kitti_tree, scenes
from ..reference import train as ref_train
from . import sweep

# what the reference reads of a batch (voxels and targets as the loader
# made them; it rebuilds the anchors and rulebooks itself)
BATCH_KEYS = ("voxels", "num_points", "coordinates", "labels",
              "reg_targets", "labels_i8", "pos_idx", "pos_targets",
              "importance")


def make_tree(tmp, seed, mix):
    """The tree, prepared by the port's create_data; the path of the
    repeated train infos."""
    from second_tpu_torch.create_data import kitti_data_prep

    root = tmp / "kitti"
    ids = kitti_tree.build_kitti_dir(root, seed, mix)
    sets = tmp / "ImageSets"
    sets.mkdir()
    for split in ("train", "val"):
        (sets / f"{split}.txt").write_text("\n".join(map(str, ids)) + "\n")
    kitti_data_prep(str(root), imageset_dir=str(sets))
    with open(root / "kitti_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)
    path = root / "kitti_infos_train_repeated.pkl"
    with open(path, "wb") as f:
        pickle.dump(infos * int(mix["repeat"]), f)
    return root, path


def build(config, mix, seed, device, tmp):
    """The step object over its loader, the weights it starts from, its
    optimizer and the batch size."""
    from second_tpu_torch.builders import dataset_builder
    from second_tpu_torch.builders.network_builder import build_network
    from second_tpu_torch.configs import load_pipeline_config
    from second_tpu_torch.core.inference import example_convert
    from second_tpu_torch.data.loader import DataLoader
    from second_tpu_torch.data.prefetch import DevicePrefetcher
    from second_tpu_torch.train import optimizer as opt_builder
    from second_tpu_torch.train.state import make_train_step

    sweep.set_precision(config)
    root, infos = make_tree(tmp, seed, mix)
    cfg = load_pipeline_config(str(common.ROOT / config["repo_config"]))
    reader = cfg.train_input_reader
    reader.dataset.kitti_root_path = str(root)
    reader.dataset.kitti_info_path = str(infos)
    reader.preprocess.database_sampler.database_info_path = str(
        root / "kitti_dbinfos_train.pkl")
    parts = build_network(cfg, device)
    net = parts["net"]
    calib = scenes.make_kitti_scene(
        np.random.RandomState(np.random.SeedSequence([seed, 2])
                              .generate_state(1)[0]),
        int(np.mean(mix["cars"])), int(np.mean(mix["points"])))[0]
    w = weights.make(net, config, seed, calib, device)
    net.load_state_dict(w, strict=True)
    opt, lr_fn, mom_fn = opt_builder.build(
        cfg.train_config.optimizer, cfg.train_config.steps,
        list(net.parameters()))
    # the sampler and the augmentations draw from the global generator
    np.random.seed(seed % 2 ** 32)
    dataset = dataset_builder.build(reader, parts, training=True,
                                    device_voxelize=False)
    loader = DataLoader(dataset, reader.batch_size, shuffle=True,
                        num_workers=reader.preprocess.num_workers,
                        mode="thread", seed=seed % 2 ** 32)
    step = make_train_step(net, parts["spec"], opt, lr_fn, mom_fn)
    anchors = {}

    def prep(example):
        # train()'s: the anchors uploaded once and kept on the device,
        # all-ones importance dropped, pinned non-blocking copies
        host = example_convert(example)
        a = host.pop("anchors")
        if "dev" not in anchors:
            anchors["dev"] = torch.from_numpy(a).to(device)
        if "importance" in host and np.all(host["importance"] == 1.0):
            host.pop("importance")
        if device.type == "cuda":
            dev = {k: torch.from_numpy(v).pin_memory().to(
                device, non_blocking=True) for k, v in host.items()}
        else:
            dev = {k: torch.from_numpy(v) for k, v in host.items()}
        dev["anchors"] = anchors["dev"]
        return dev

    def batches():
        while True:  # one DevicePrefetcher per epoch, as train() has
            yield from DevicePrefetcher(loader, prep)

    names = [n for n, _ in net.named_parameters()]
    return {"net": net, "step": step, "opt": opt, "batches": batches(),
            "w0": {n: w[n].detach().clone() for n in names}, "names": names,
            "batch": reader.batch_size, "cfg": cfg}


def first_steps(state, k):
    """The step's first ``k`` steps through the window's feed: their
    batches (for the reference), losses, the optimizer's first moment
    after step 1 and the parameters after step ``k``."""
    kept, losses, mu1 = [], [], None
    for t in range(k):
        ex = next(state["batches"])
        kept.append({key: ex[key].clone() for key in BATCH_KEYS
                     if key in ex})
        losses.append(state["step"](ex)["loss"])
        if t == 0:
            mu1 = [m.clone() for m in state["opt"].mu]
    params = {n: p.detach().clone()
              for n, p in state["net"].named_parameters()}
    return {"batches": kept, "losses": [float(x) for x in losses],
            "mu1": dict(zip(state["names"], mu1)), "params": params}


def leaf_gaps(prog, ref, keep):
    """The widest gap over the kept leaves between the port's norm of a
    leaf and the reference's, over the larger of the reference's norm of
    that leaf and of the median leaf."""
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in keep}
    med = float(np.median(list(rn.values())))
    gaps = [abs(float(torch.linalg.vector_norm(prog[n].double())) - rn[n])
            / max(rn[n], med) for n in keep]
    return max(gaps) if gaps else 0.0


def judge(model, opt_cfg, first, w0, names, ref):
    """The numbers of the port's first steps (``first``) against the
    reference's (``ref`` = losses, clipped first gradients, weights after
    the steps). Leaves whose reference gradient is under a thousandth of
    the median leaf's are left out of both norms."""
    ref_losses, ref_g1, ref_w = ref
    b1 = ref_train.one_cycle(opt_cfg, 0)[1]
    g1 = {n: first["mu1"][n] / (1 - b1) for n in names}
    gn = {n: float(torch.linalg.vector_norm(ref_g1[n].double()))
          for n in names}
    med = float(np.median(list(gn.values())))
    keep = [n for n in names if gn[n] >= 1e-3 * med]
    loss_err = max(abs(p - r) / abs(r)
                   for p, r in zip(first["losses"], ref_losses))
    d_prog = {n: first["params"][n] - w0[n] for n in keep}
    d_ref = {n: ref_w[n] - w0[n] for n in keep}
    loss1 = abs(first["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
    return {"loss_err": loss_err, "loss1_err": loss1,
            "grad_err": leaf_gaps(g1, ref_g1, keep),
            "change_err": leaf_gaps(d_prog, d_ref, keep),
            "leaves_left_out": len(names) - len(keep)}


def reference(config, w0, names, batches, device):
    return ref_train.run_steps(config["model"], config["optimizer"], w0,
                               names, batches, device)


def _ops_per_frame(model, batches, device):
    """Operations of one frame's training step (forward, and the
    backward's input and weight gradients of every conv but the first
    sparse conv's input gradient), averaged over the batches' frames."""
    total, frames = 0, 0
    for b in batches:
        coords = b["coordinates"]
        for f in range(coords.shape[0]):
            c = coords[f][coords[f][:, 0] >= 0]
            work, shape = flops.middle_work(model, c, device)
            fwd = sum(2 * w["pairs"] * w["cin"] * w["cout"] for w in work)
            ch = model["middle_topology"][-1][1] * shape[1]
            fwd += flops.rpn_flops(model, ch, shape[2], shape[3])
            first = work[0]
            total += 3 * fwd - 2 * (first["pairs"] * first["cin"]
                                    * first["cout"])
            frames += 1
    return total / max(frames, 1)


def run(env):
    config, mix, seed = env["config"], env["mix"], env["seed"]
    device = env["device"]
    model = config["model"]
    state = build(config, mix, seed, device, env["tmp"])
    first = first_steps(state, mix["reference_steps"])
    for _ in range(mix["warmup_steps"]):
        state["step"](next(state["batches"]))
    if env["trace"]:
        with sweep.profiler():
            state["step"](next(state["batches"]))
    sweep.sync(device)
    setup_s = time.perf_counter() - env["t_process"]

    seconds, traced = env["seconds"], env["trace"]
    fetch, spent = [], []
    prof, prof_at, t_prof = None, None, None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    prof_from = (deadline - min(seconds * sweep.PROFILE_SHARE,
                                sweep.PROFILE_MAX_S)
                 if traced else float("inf"))
    n = 0
    step, it = state["step"], state["batches"]
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        if prof is None and t0 >= prof_from:
            prof = sweep.profiler()
            prof.__enter__()
            prof_at, t_prof = n, t0
            t0 = time.perf_counter()
        rf = (torch.profiler.record_function if prof is not None
              else lambda name: contextlib.nullcontext())
        with rf("bench.request"):
            with rf("bench.fetch"):
                ex = next(it)
            t1 = time.perf_counter()
            with rf("bench.step"):
                step(ex)
                if traced and prof is None:
                    sweep.sync(device)
            t2 = time.perf_counter()
        fetch.append(t1 - t0)
        spent.append(t2 - t1)
        n += 1
    sweep.sync(device)
    t_end = time.perf_counter()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    trace_out = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = env["tmp"] / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        trace_out = trace.reduce_trace(path)
    w0, names, batch = state["w0"], state["names"], state["batch"]
    del state, step, it, ex
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference(config, w0, names, first["batches"], device)
    numbers = judge(model, config["optimizer"], first, w0, names, ref)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", flush=True)
    left_out = numbers.pop("leaves_left_out")
    record = {
        "attempted": n, "failed": 0, "numbers": numbers,
        "compared": len(first["batches"]), "left_out": left_out,
        "memory_peak_bytes": memory_peak, "setup_s": setup_s,
        "window_s": t_end - t_start, "frames": n * batch, "trace": trace_out,
    }
    if traced:
        m = prof_at if prof_at is not None else n
        record["spans"] = {"fetch": fetch[:m], "step": spent[:m]}
        record["unprofiled_s"] = (t_prof if t_prof is not None
                                  else t_end) - t_start
        record["ops"] = [_ops_per_frame(model, first["batches"], device)
                         * batch] * m
    limits = env["limits"]
    record["correct"] = all(numbers[k] <= limits[k] for k in limits)
    return record
