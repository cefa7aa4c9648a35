"""One nuScenes sensor stream in a closed loop at batch 1, on the residual
sparse network: each request is
``InferenceContext.get_inference_input_dict({"token": ...}, points)``
on a frame of the mix's pool (a key frame and 9 earlier sweeps,
``gen/nusc_scenes.py``), which ships the host voxels sorted by linear
id, then ``InferenceContext.inference``, whose middle builds its
rulebooks on the card; the next is sent when the previous one's
detections are on the host.

The window, the sample and the record are ``nusc_sweep.py``'s; what
differs is the model's: its weights (``res8x_weights.py``, fitted on
the pool), its
reference (``reference/res8x.py``, judged with the labels by
``multihead.judge``), its operations and least times (``res8x_flops.py``)
and, in a traced run, the device time under the port's
``net.middle.wide`` span (``stages.attribute``). The middle's stage
counts come back from the card with every request (the third of
``InferenceContext._run``'s results); ``sparse_rows_overflow``, the
active sites beyond a stage's capacity summed over the run's requests,
is judged with the reference's numbers: the reference never drops a
site.
"""

import contextlib
import json
import time

import torch

from .. import common, res8x_flops, res8x_weights, stages, trace
from ..gen import nusc_scenes
from ..reference import judge, multihead, res8x
from .nusc_sweep import info
from .sweep import (PROFILE_MAX_S, PROFILE_SHARE, Capture, profiler,
                    set_precision, sync)

WIDE_SPAN = "net.middle.wide"


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
    pool = nusc_scenes.frame_pool(seed, mix)
    w = res8x_weights.make(net, config, seed, pool, device)
    net.load_state_dict(w, strict=True)
    return ctx, w, pool


class StageCounts:
    """The hook on the context's ``_run`` that keeps each request's
    stage counts [B, S, 2] (true active, capacity), on the device."""

    def __init__(self, ctx):
        self.counts = []
        inner = ctx._run

        def _run(example):
            out = inner(example)
            if out[2] is not None:
                self.counts.append(out[2])
            return out

        ctx._run = _run

    def overflow(self):
        """Active sites beyond capacity, summed over stages and
        requests."""
        if not self.counts:
            return 0
        c = torch.stack(self.counts)
        return int((c[..., 0] - c[..., 1]).clamp(min=0).sum())


def span_per_request(path, name):
    """Device seconds under the span ``name`` a profiled request, or None
    where the program has no such span."""
    with open(path) as f:
        dev = stages.attribute(json.load(f)["traceEvents"])
    spent = dev["stages_s"].get(name)
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
            refs[c["pool"]] = res8x.request(
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


def frame_work(model, points, device):
    """(operations, K1's least time, the wide stage's) of one frame."""
    _, (_, _, coords) = res8x.host_example(model, points)
    return res8x_flops.request_work(model, res8x.plan(model, coords,
                                                      device)[0])


def run(env):
    config, mix, seed = env["config"], env["mix"], env["seed"]
    device = env["device"]
    model = config["model"]
    ctx, w, pool = build(config, mix, seed, device)
    cap = Capture(ctx, mix["sample"], seed)
    counts = StageCounts(ctx)
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
    overflow = counts.overflow()
    trace_out, wide_s = None, None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = env["tmp"] / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        trace_out = trace.reduce_trace(path)
        wide_s = span_per_request(path, WIDE_SPAN)
    del ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, refs = judge_sample(model, w, pool, cap.slots.values(), mix,
                                 device)
    numbers["sparse_rows_overflow"] = overflow
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
        work = {i: frame_work(model, pool[i], device) for i in set(which)}
        record["ops"] = [work[i][0] for i in which[:m]]
        if trace_out is not None:
            record["k1_bound_s"] = sum(work[i][1] for i in which[m:])
            record["wide_bound_s"] = sum(work[i][2] for i in which[m:])
        if wide_s is not None:
            record["wide_gpu_s"] = wide_s
    limits = env["limits"]
    record["correct"] = (failed == 0 and len(cap.slots) > 0
                         and all(numbers[k] <= limits[k] for k in limits))
    return record
