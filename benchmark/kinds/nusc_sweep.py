"""One nuScenes sensor stream in a closed loop at batch 1, on the
multi-head network: each request is
``InferenceContext.get_inference_input_dict({"token": ...}, points)``
on a frame of the mix's pool (a key frame and 9 earlier sweeps,
``gen/nusc_scenes.py``), then ``InferenceContext.inference``; the next
is sent when the previous one's detections are on the host.

The window, the sample and the record are ``sweep.py``'s; what differs
is the model's: its weights (``mhead_weights.py``), its reference
(``reference/multihead.py``, whose judge also checks each detection's
label), its operations (``mhead_flops.py``), and, in a traced run, the
device time under the port's ``net.heads`` span (``stages.attribute``)
with the heads' least time beside it.
"""

import contextlib
import json
import time

import numpy as np
import torch

from .. import common, mhead_flops, mhead_weights, stages, trace
from ..gen import nusc_scenes
from ..reference import judge, multihead
from .sweep import (PROFILE_MAX_S, PROFILE_SHARE, Capture, profiler,
                    set_precision, sync)

HEADS_SPAN = "net.heads"


def build(config, mix, seed, device):
    """The port's InferenceContext with the seed's weights, the weights,
    and the pool of frames."""
    from second_tpu_torch.core.inference import InferenceContext

    set_precision(config)
    ctx = InferenceContext()
    path = common.ROOT / config["repo_config"]
    ctx.build(str(path), device, **dict(config["build"],
                                        **mix.get("build", {})))
    net = ctx.parts["net"]
    net.eval()
    sizes = nusc_scenes.pool_sizes(mix)
    calib = nusc_scenes.make_frame(
        np.random.default_rng([seed, 2]), *sizes[len(sizes) // 2])[0]
    w = mhead_weights.make(net, config, seed, calib, device)
    net.load_state_dict(w, strict=True)
    return ctx, w, nusc_scenes.frame_pool(seed, mix)


def info(i):
    """The nuScenes info a request names its frame by."""
    return {"token": f"frame{i:04d}"}


def heads_per_request(path):
    """Device seconds under ``net.heads`` a profiled request, or None
    where the program has no such span."""
    with open(path) as f:
        dev = stages.attribute(json.load(f)["traceEvents"])
    spent = dev["stages_s"].get(HEADS_SPAN)
    if not spent or not dev["requests"]:
        return None
    return spent / dev["requests"]


def judge_sample(model, w, pool, slots, mix, device):
    """The reference's numbers over the sample, once per distinct frame."""
    tol = mix["tolerance"]
    refs = {}
    numbers = {"prep_mismatch": 0, "preds_err": 0.0, "det_err": 0.0,
               "nms_violations": 0}
    for c in slots:
        if c["pool"] not in refs:
            refs[c["pool"]] = multihead.request(
                model, w, pool[c["pool"]], device, mix["candidate_margin"])
        ref = refs[c["pool"]]
        numbers["prep_mismatch"] += judge.prep_mismatch(c["ex"], ref["ex"])
        numbers["preds_err"] = max(numbers["preds_err"],
                                   judge.preds_err(c["preds"], ref["preds"]))
        d_err, bad, _ = multihead.judge(model, c["boxes"], c["scores"],
                                        c["labels"], ref["cand"], tol)
        numbers["det_err"] = max(numbers["det_err"], d_err)
        numbers["nms_violations"] += bad
    return numbers, refs


def run(env):
    config, mix, seed = env["config"], env["mix"], env["seed"]
    device = env["device"]
    model = config["model"]
    ctx, w, pool = build(config, mix, seed, device)
    cap = Capture(ctx, mix["sample"], seed)
    # warm-up: every frame of the pool once
    for i, pts in enumerate(pool[:mix["warmup"]]):
        ctx.inference(ctx.get_inference_input_dict(info(i), pts))
    if env["trace"]:
        # the profiler's first start initialises the device tracer, which
        # takes seconds: do it in set-up, not in the window
        with profiler():
            ctx.inference(ctx.get_inference_input_dict(info(0), pool[0]))
    sync(device)
    setup_s = time.perf_counter() - env["t_process"]

    seconds, traced = env["seconds"], env["trace"]
    lat, prep, dev, which = [], [], [], []
    failed = 0
    prof, prof_at, t_prof = None, None, None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    prof_from = (deadline - min(seconds * PROFILE_SHARE, PROFILE_MAX_S)
                 if traced else float("inf"))
    n = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        if prof is None and t0 >= prof_from:
            prof = profiler()
            prof.__enter__()
            prof_at, t_prof = n, t0
            t0 = time.perf_counter()
        rf = (torch.profiler.record_function if prof is not None
              else lambda name: contextlib.nullcontext())
        i = n % len(pool)
        slot = cap.slot_for(n)
        cap.current = {"pool": i} if slot is not None else None
        try:
            with rf("bench.request"):
                with rf("bench.host_prep"):
                    ex = ctx.get_inference_input_dict(info(i), pool[i])
                t1 = time.perf_counter()
                with rf("bench.device_path"):
                    out = ctx.inference(ex)[0]
                t2 = time.perf_counter()
        except Exception as err:  # a request that fails counts as failed
            print(f"request {n} failed: {err!r}", flush=True)
            failed += 1
            n += 1
            continue
        lat.append(t2 - t0)
        prep.append(t1 - t0)
        dev.append(t2 - t1)
        which.append(i)
        if slot is not None:
            cap.current.update(ex=ex, boxes=out["box3d_lidar"],
                               scores=out["scores"],
                               labels=out["label_preds"])
            cap.slots[slot] = cap.current
        cap.current = None
        n += 1
    t_end = time.perf_counter()
    sync(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    trace_out, heads_s = None, None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = env["tmp"] / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        trace_out = trace.reduce_trace(path)
        heads_s = heads_per_request(path)
    del ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, refs = judge_sample(model, w, pool, cap.slots.values(), mix,
                                 device)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", flush=True)
    record = {
        "attempted": n, "failed": failed, "numbers": numbers,
        "compared": len(cap.slots), "memory_peak_bytes": memory_peak,
        "setup_s": setup_s, "window_s": t_end - t_start,
        "latencies_s": lat, "trace": trace_out,
    }
    if traced:
        # spans and the rate from the unprofiled part of the window
        m = prof_at if prof_at is not None else len(lat)
        record["spans"] = {"host_prep": prep[:m], "device_path": dev[:m]}
        record["unprofiled_s"] = (t_prof if t_prof is not None
                                  else t_end) - t_start
        ops = {}
        for i in set(which[:m]):
            counts = (refs[i]["net_in"][1] if i in refs
                      else multihead.host_example(model, pool[i])[1][1])
            ops[i] = mhead_flops.request_ops(model, counts)
        record["ops"] = [ops[i] for i in which[:m]]
        if heads_s is not None:
            record["heads_gpu_s"] = heads_s
            record["heads_bound_s"] = mhead_flops.heads_bound_s(model)
    limits = env["limits"]
    record["correct"] = (failed == 0 and len(cap.slots) > 0
                         and all(numbers[k] <= limits[k] for k in limits))
    return record
