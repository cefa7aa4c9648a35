"""Run one cell of BENCHMARK.json on the card and print one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the first run's kernel builds, the port's context, the
seed's weights and inputs, warm-up) is ``setup_s``; then the window runs
for ``--seconds``; then the reference judges what the window produced.
``--trace 1`` reports the cell's per-layer metrics instead of its
end-to-end ones, from the same run with part of its window under the
profiler. Without enough CUDA devices, or with JAX or the JAX package
loaded, the run exits non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import common  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def check_device(chips):
    """The card(s) the cell asks for, or exit: never the CPU."""
    import torch

    if not torch.cuda.is_available():
        common.fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        common.fail(f"{torch.cuda.device_count()} CUDA device(s), the cell "
                    f"needs {chips}")
    return torch.cuda.get_device_name(0)


def metrics_of(bench, cell, section, record):
    out = {}
    for m in common.cell_metrics(bench, cell, section):
        value = common.load_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None):
    args = parse(argv)
    common.set_cache_env()
    bench = common.load_benchmark()
    cell = common.find_cell(bench, args.workload)
    config = common.load_config(cell["config"])
    common.set_host_allocator(config)
    mix = common.load_mix(cell["traffic"])
    limits = common.load_limits(cell["name"])
    kind = importlib.import_module(f"benchmark.kinds.{mix['kind']}")
    device_name = check_device(cell["chips"])
    import torch

    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        record = kind.run({
            "cell": cell, "config": config, "mix": mix, "seed": args.seed,
            "seconds": args.seconds, "trace": bool(args.trace),
            "limits": limits, "tmp": Path(tmp), "t_process": T_PROCESS,
            "device": torch.device("cuda", 0)})
    found = common.forbidden_loaded()
    if found:
        common.fail("loaded in this process: " + ", ".join(found))
    section = "per_layer" if args.trace else "end_to_end"
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in record["numbers"].items() if k in limits}
    readings = {k: v for k, v in record["numbers"].items()
                if k not in limits}
    device = {"platform": "gpu", "kind": device_name,
              "count": cell["chips"],
              "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": record["correct"], "attempted": record["attempted"],
              "failed": record["failed"],
              "metrics": metrics_of(bench, cell["name"], section, record),
              "device": device}
    tr = record.get("trace")
    if args.trace:
        if tr is None:
            common.fail("the traced window recorded no request")
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["compared"] = record["compared"]
    result["readings"] = readings
    result["checks"] = checks
    for k, v in readings.items():
        print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
