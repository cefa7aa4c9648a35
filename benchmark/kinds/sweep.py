"""One sensor stream in a closed loop at batch 1: each request is
``InferenceContext.get_inference_input_dict`` then
``InferenceContext.inference`` on a sweep of the mix's pool, and the
next is sent when the previous one's detections are on the host.

A sample of the window's requests, drawn from the seed as they are sent
(a reservoir), keeps what the timed path produced: the request's host
arrays, the network's preds and the returned detections. Once the window
has closed and the port is freed, the reference judges them.
"""

import contextlib
import time

import numpy as np
import torch

from .. import common, flops, trace, weights
from ..gen import scenes
from ..reference import judge, pipeline

# the part of a traced run's window that runs under the profiler (the
# rest gives the spans and the rate, unprofiled)
PROFILE_SHARE = 0.5
PROFILE_MAX_S = 8.0


def set_precision(config):
    tf32 = bool(config["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def build(config, mix, seed, device):
    """The port's InferenceContext with the seed's weights, the weights,
    and the pool of sweeps."""
    from second_tpu_torch.core.inference import InferenceContext

    set_precision(config)
    ctx = InferenceContext()
    path = common.ROOT / config["repo_config"]
    ctx.build(str(path), device, **dict(config["build"],
                                        **mix.get("build", {})))
    net = ctx.parts["net"]
    net.eval()
    calib = scenes.make_kitti_scene(
        np.random.RandomState(np.random.SeedSequence([seed, 2])
                              .generate_state(1)[0]),
        int(np.mean(mix["cars"])), int(np.mean(mix["points"])))[0]
    w = weights.make(net, config, seed, calib, device)
    net.load_state_dict(w, strict=True)
    return ctx, w, scenes.sweep_pool(seed, mix)


def profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Capture:
    """Reservoir of ``k`` requests drawn from the seed, and the hook on
    the context's ``_run`` (which ``inference`` calls) that keeps the
    preds of the request being captured."""

    def __init__(self, ctx, k, seed):
        self.k = k
        self.rng = np.random.default_rng([seed, 3])
        self.slots = {}
        self.current = None
        inner = ctx._run

        def _run(example):
            out = inner(example)
            if self.current is not None:
                self.current["preds"] = {n: v[0] for n, v in out[0].items()}
            return out

        ctx._run = _run

    def slot_for(self, n):
        if n < self.k:
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k else None


def run(env):
    config, mix, seed = env["config"], env["mix"], env["seed"]
    device = env["device"]
    model = config["model"]
    ctx, w, pool = build(config, mix, seed, device)
    cap = Capture(ctx, mix["sample"], seed)
    # warm-up: the window's requests run slower until every sweep of the
    # pool has been through once
    for pts in pool[:mix["warmup"]]:
        ctx.inference(ctx.get_inference_input_dict({}, pts))
    if env["trace"]:
        # the profiler's first start initialises the device tracer, which
        # takes seconds: do it in set-up, not in the window
        with profiler():
            ctx.inference(ctx.get_inference_input_dict({}, pool[0]))
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
                    ex = ctx.get_inference_input_dict({}, pool[i])
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
                               scores=out["scores"])
            cap.slots[slot] = cap.current
        cap.current = None
        n += 1
    t_end = time.perf_counter()
    sync(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    trace_out = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = env["tmp"] / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        trace_out = trace.reduce_trace(path)
    del ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once per distinct sweep of the sample
    limits, tol = env["limits"], mix["tolerance"]
    t_ref = time.perf_counter()
    refs = {}
    numbers = {"prep_mismatch": 0, "preds_err": 0.0, "det_err": 0.0,
               "nms_violations": 0}
    for c in cap.slots.values():
        if c["pool"] not in refs:
            refs[c["pool"]] = pipeline.request(
                model, w, pool[c["pool"]], device, mix["candidate_margin"])
        ref = refs[c["pool"]]
        numbers["prep_mismatch"] += judge.prep_mismatch(c["ex"], ref["ex"])
        numbers["preds_err"] = max(numbers["preds_err"],
                                   judge.preds_err(c["preds"], ref["preds"]))
        d_err, bad, _ = judge.judge(model, c["boxes"], c["scores"],
                                    ref["cand"], tol)
        numbers["det_err"] = max(numbers["det_err"], d_err)
        numbers["nms_violations"] += bad
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
        work = {}
        for i in set(which):
            _, (vox, counts, coords) = pipeline.host_example(model, pool[i])
            work[i] = flops.request_work(model, coords, counts, device)
        record["ops"] = [work[i][0] for i in which[:m]]
        if trace_out is not None:
            record["k1_bound_s"] = sum(work[i][1] for i in which[m:])
    correct = (failed == 0 and len(cap.slots) > 0
               and all(numbers[k] <= limits[k] for k in limits))
    record["correct"] = correct
    return record
