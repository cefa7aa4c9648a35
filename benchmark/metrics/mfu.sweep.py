"""The network's operations per sweep (counted by the benchmark from the
shapes and the reference's rulebooks), summed over the sweeps of the
unprofiled part of the window, over its wall time, as a share of
PEAK_FLOPS (3xTF32, 165 TFLOP/s)."""

from benchmark.flops import PEAK_FLOPS


def read(run):
    ops, secs = run.get("ops"), run.get("unprofiled_s")
    if not ops or not secs:
        return None
    return 100.0 * sum(ops) / secs / PEAK_FLOPS
