"""The port's stages inside a sweep cell: each request's host time and
counts by stage, from the port's span registry
(``second_tpu_torch.utils.timer``), and a profiled window's device time
by stage, each kernel, memcpy or memset charged, through its launch
(``args.correlation``), to the innermost program span around that
launch on the launching thread.

    python3 -m benchmark.stages --workload <cell> --seed <n> --seconds <s>

runs the cell's set-up (``kinds.sweep.build``, the warm-up), then
``--seconds`` of requests in blocks with collection off and on in turns
(off, on, on, off, ...: what tracing costs, and the host split from the
blocks with it on), then up to ``--seconds`` more under the profiler with
collection off, and prints one JSON line. ``benchmark.run`` does not
call it.
"""

import argparse
import bisect
import json
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

from benchmark import common, trace

# the spans the benchmark puts around the calls into the port; every
# other user annotation is the program's
BENCH_PREFIX = "bench."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_STAGES = ("prep.voxelize", "prep.plan", "prep.anchor_mask",
               "prep.pack")
DEVICE_STAGES = ("upload", "net.encode", "net.middle", "net.rpn",
                 "net.predict")
BLOCK = 16  # requests per block of the off/on turns


def attribute(events):
    """Device seconds by program stage of a Chrome trace's events, inside
    the window ``trace.reduce_trace`` uses (the ``bench.request`` ranges,
    else the whole trace), clipped to it as there: {"requests",
    "stages_s": {stage: s}, "unattributed_s", "device_s", "top_ops":
    {stage (None: unattributed): [[op, s]] of its three longest}}."""
    reqs = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == trace.REQUEST]
    if reqs:
        t0 = min(e["ts"] for e in reqs)
        t1 = max(e["ts"] + e["dur"] for e in reqs)
    else:
        t0, t1 = float("-inf"), float("inf")
    spans = defaultdict(list)  # (pid, tid) -> [(start, end, name)]
    launches = {}  # correlation -> (pid, tid, ts)
    for e in events:
        cat = e.get("cat")
        if (cat == "user_annotation" and "dur" in e
                and not e["name"].startswith(BENCH_PREFIX)):
            spans[e["pid"], e["tid"]].append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["pid"], e["tid"],
                                                  e["ts"])
    starts = {}
    for key, xs in spans.items():
        xs.sort()
        starts[key] = [s for s, _, _ in xs]
    stages = defaultdict(float)
    ops = defaultdict(lambda: defaultdict(float))
    unattributed = total = 0.0
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS or "dur" not in e:
            continue
        secs = (min(e["ts"] + e["dur"], t1) - max(e["ts"], t0)) * 1e-6
        if secs <= 0:
            continue
        total += secs
        name = None
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            pid, tid, ts = launch
            xs = spans.get((pid, tid), [])
            i = bisect.bisect_right(starts.get((pid, tid), []), ts)
            # the latest-starting span that holds the launch is the
            # innermost one
            for s, end, n in reversed(xs[:i]):
                if end >= ts:
                    name = n
                    break
        if name is None:
            unattributed += secs
        else:
            stages[name] += secs
        ops[name][e["name"]] += secs
    top = {stage: sorted(([k, v] for k, v in by_op.items()),
                         key=lambda kv: -kv[1])[:3]
           for stage, by_op in ops.items()}
    return {"requests": len(reqs), "stages_s": dict(stages),
            "unattributed_s": unattributed, "device_s": total,
            "top_ops": top}


def per_request(snap):
    """{request: {"s": {stage: seconds}, "counts": {name: n}}} of a
    ``timer.snapshot()``, requests only (spans outside one are left
    out)."""
    out = defaultdict(lambda: {"s": defaultdict(float), "counts": {}})
    for s in snap["spans"]:
        if s.request is not None:
            out[s.request]["s"][s.name] += (s.end_ns - s.start_ns) * 1e-9
    for rid, counts in snap["counts"].items():
        if rid is not None:
            out[rid]["counts"] = dict(counts)
    return {rid: {"s": dict(r["s"]), "counts": r["counts"]}
            for rid, r in out.items()}


def _median(xs):
    return statistics.median(xs) if xs else None


def host_split(reqs, prep_s, device_s):
    """Medians a request over the collected requests (``per_request``'s
    values, with the benchmark's ``bench.host_prep`` and
    ``bench.device_path`` seconds of each): ms by stage, the prep stages'
    sum and the device stages' host sum, beside both spans; MB uploaded;
    the sparse fill in %."""
    ms = lambda xs: _median([x * 1e3 for x in xs])  # noqa: E731
    stages = sorted({n for r in reqs for n in r["s"]})
    out = {"stage_ms": {n: ms([r["s"].get(n, 0.0) for r in reqs])
                        for n in stages},
           "prep_sum_ms": ms([sum(r["s"].get(n, 0.0) for n in HOST_STAGES)
                              for r in reqs]),
           "device_host_sum_ms": ms([sum(r["s"].get(n, 0.0)
                                         for n in DEVICE_STAGES)
                                     for r in reqs]),
           "host_prep_ms": ms(prep_s), "device_path_ms": ms(device_s)}
    up = [r["counts"]["upload_bytes"] / 1e6 for r in reqs
          if "upload_bytes" in r["counts"]]
    out["upload_mb"] = _median(up)
    fill = [100.0 * r["counts"]["sparse_rows_active"]
            / r["counts"]["sparse_rows_capacity"] for r in reqs
            if r["counts"].get("sparse_rows_capacity")]
    out["sparse_fill_pct"] = _median(fill)
    return out


def prep_labelled_share(idle_gaps):
    """Share (%) of the host-preparation idle time in ``reduce_trace``'s
    ten largest labels that carries a program stage's label."""
    prep = {k: v for k, v in idle_gaps if k.startswith("host_prep/")}
    total = sum(prep.values())
    named = sum(v for k, v in prep.items()
                if k.split("/", 1)[1].startswith("prep."))
    return 100.0 * named / total if total else None


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [q[0] * 1e3, q[1] * 1e3, q[2] * 1e3]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    common.set_cache_env()
    bench = common.load_benchmark()
    cell = common.find_cell(bench, args.workload)
    config = common.load_config(cell["config"])
    common.set_host_allocator(config)
    mix = common.load_mix(cell["traffic"])
    import torch

    from benchmark.run import check_device
    from benchmark.kinds import sweep
    from second_tpu_torch.utils import timer

    name = check_device(cell["chips"])
    device = torch.device("cuda", 0)
    ctx, _, pool = sweep.build(config, mix, args.seed, device)
    for pts in pool[:mix["warmup"]]:
        ctx.inference(ctx.get_inference_input_dict({}, pts))
    with sweep.profiler():
        ctx.inference(ctx.get_inference_input_dict({}, pool[0]))
    sweep.sync(device)

    lat = {False: [], True: []}
    prep_s, dev_s, rids = [], [], []
    timer.reset()
    n, block = 0, 0
    deadline = time.perf_counter() + args.seconds
    while time.perf_counter() < deadline:
        on = block % 4 in (1, 2)
        timer.collect(on)
        for _ in range(BLOCK):
            pts = pool[n % len(pool)]
            t0 = time.perf_counter()
            ex = ctx.get_inference_input_dict({}, pts)
            t1 = time.perf_counter()
            ctx.inference(ex)
            t2 = time.perf_counter()
            lat[on].append(t2 - t0)
            if on:
                prep_s.append(t1 - t0)
                dev_s.append(t2 - t1)
                rids.append(ex[timer.REQUEST_KEY])
            n += 1
        block += 1
    timer.collect(False)
    reqs = per_request(timer.snapshot())
    split = host_split([reqs[r] for r in rids], prep_s, dev_s)
    timer.reset()

    rf = torch.profiler.record_function
    with tempfile.TemporaryDirectory(prefix="stages-") as tmp:
        path = Path(tmp) / "trace.json"
        prof = sweep.profiler()
        with prof:
            deadline = time.perf_counter() + min(args.seconds,
                                                 sweep.PROFILE_MAX_S)
            while time.perf_counter() < deadline:
                pts = pool[n % len(pool)]
                with rf("bench.request"):
                    with rf("bench.host_prep"):
                        ex = ctx.get_inference_input_dict({}, pts)
                    with rf("bench.device_path"):
                        ctx.inference(ex)
                n += 1
        prof.export_chrome_trace(str(path))
        del prof
        reduced = trace.reduce_trace(path)
        with open(path) as f:
            dev = attribute(json.load(f)["traceEvents"])
    k = max(dev["requests"], 1)
    kernels = sum(reduced["kernels"].values())
    p50 = {mode: statistics.median(xs) * 1e3 for mode, xs in lat.items()}
    out = {
        "workload": args.workload, "seed": args.seed, "device": name,
        "requests": {"off": len(lat[False]), "on": len(lat[True]),
                     "profiled": dev["requests"]},
        "p50_ms": {"off": p50[False], "on": p50[True]},
        "quartiles_ms": {"off": _quartiles(lat[False]),
                         "on": _quartiles(lat[True])},
        "cost_pct": 100.0 * (p50[True] / p50[False] - 1.0),
        "host": split,
        "gpu_ms": {s: v * 1e3 / k for s, v in dev["stages_s"].items()},
        "unattributed_ms": dev["unattributed_s"] * 1e3 / k,
        "top_ops_ms": {str(s): [[n, v * 1e3 / k] for n, v in xs]
                       for s, xs in dev["top_ops"].items()},
        "device_ms": dev["device_s"] * 1e3 / k,
        "kernels_ms": kernels * 1e3 / k,
        "idle_share": 100.0 * (1.0 - reduced["busy_s"]
                               / reduced["window_s"]),
        "idle_gaps": reduced["idle_gaps"],
        "prep_idle_labelled_pct": prep_labelled_share(
            reduced["idle_gaps"]),
        "device_ops": reduced["device_ops"],
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
