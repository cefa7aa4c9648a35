"""Reduce a ``torch.profiler`` Chrome trace of part of the window to the
device's busy time, the kernels' time by name, and the idle gaps by what
the host was doing.

The traced window runs from the start of the first ``bench.request``
range to the end of the last. A device operation is a kernel, a memcpy
or a memset; busy time is the union of their intervals inside the
window.
"""

import json
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
REQUEST = "bench.request"
# gaps labelled one by one (the longest); the rest are summed as "other"
LABELLED_GAPS = 500


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    reqs = [e for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == REQUEST]
    if not reqs:
        return None
    t0 = min(e["ts"] for e in reqs)
    t1 = max(e["ts"] + e["dur"] for e in reqs)
    by_name = defaultdict(float)
    intervals = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            s, end = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if end > s:
                intervals.append((s, end))
                by_name[e["name"]] += (end - s) * 1e-6
    merged = _merge(intervals)
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps, prev = [], t0
    for s, e in merged:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((t1 - prev, prev, t1))
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
    hs = np.array([e["ts"] for e in host], np.float64)
    he = hs + np.array([e["dur"] for e in host], np.float64)
    idle = defaultdict(float)
    gaps.sort(reverse=True)
    for dur, s, e in gaps[:LABELLED_GAPS]:
        mid = (s + e) / 2
        cover = np.flatnonzero((hs <= mid) & (he >= mid))
        stage = [host[i]["name"] for i in cover
                 if host[i]["name"].startswith("bench.")
                 and host[i]["name"] != REQUEST]
        ops = [i for i in cover if not host[i]["name"].startswith("bench.")]
        inner = (host[max(ops, key=lambda i: hs[i])]["name"] if ops
                 else "python")
        outer = stage[0][len("bench."):] if stage else "between"
        label = outer + "/" + inner
        idle[label] += dur * 1e-6
    rest = sum(d for d, _, _ in gaps[LABELLED_GAPS:]) * 1e-6
    if rest:
        idle["other"] += rest
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy,
            "requests": len(reqs), "kernels": dict(by_name),
            "device_ops": top(by_name), "idle_gaps": top(idle)}
