"""What every cell shares: finding a cell's files by name, the caches'
fixed directories, the device check, metric readers, quartiles, and the
result line."""

import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the JAX stack and the JAX package: none of them may be loaded, compared
# by whole top-level module name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "second_tpu")
# fixed build and kernel caches inside the checkout
CACHE_DIR = ROOT / ".bench_cache"
# the glibc mallopt(3) parameters a configuration may set, by name
MALLOPT_PARAMS = {"M_TRIM_THRESHOLD": -1, "M_MMAP_THRESHOLD": -3}


def set_cache_env():
    """Point the kernel caches at fixed directories of the checkout (the
    port's nvcc and g++ libraries already build into its own tree)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")


def set_host_allocator(config):
    """Set the glibc allocator parameters of the configuration's
    ``"host": {"mallopt": {name: value}}`` in this process, or exit on a
    name it does not know or a value the C library refuses. With both
    thresholds high the heap keeps the buffers a request frees, and the
    next request reuses them instead of faulting in fresh pages."""
    settings = config.get("host", {}).get("mallopt", {})
    if not settings:
        return
    import ctypes

    libc = ctypes.CDLL("libc.so.6")
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.mallopt.restype = ctypes.c_int
    for name, value in settings.items():
        if name not in MALLOPT_PARAMS:
            fail(f"unknown mallopt parameter {name!r}")
        if libc.mallopt(MALLOPT_PARAMS[name], value) != 1:
            fail(f"the C library refused mallopt({name}, {value})")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def load_config(name):
    return load_json(HERE / "configs" / f"{name}.json")


def load_mix(name):
    return load_json(HERE / "traffic" / f"{name}.json")


def load_limits(cell):
    return load_json(HERE / "limits" / f"{cell}.json")


def find_cell(bench, name):
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench, cell, section):
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(metric):
    """The reader of a metric: ``metrics/<name>.py``, whose ``read(run)``
    returns the value or None when there is nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_loaded():
    """Top-level names of loaded modules that are in FORBIDDEN_MODULES."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def percentile(values, q):
    """The q-th percentile (0-100) of all values, linear between ranks."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def fail(msg, code=2):
    """Exit without a result line."""
    print(msg, file=sys.stderr, flush=True)
    raise SystemExit(code)
