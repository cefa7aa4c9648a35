"""The training step's operations (forward, and the backward's input
and weight gradients, counted by the benchmark from the shapes and the
reference's rulebooks of the set-up's batches) times the steps of the
unprofiled part of the window, over its wall time, as a share of
PEAK_FLOPS (3xTF32, 165 TFLOP/s); global steps across ranks."""

from benchmark.flops import PEAK_FLOPS


def read(run):
    ops, secs = run.get("ops"), run.get("unprofiled_s")
    if not ops or not secs:
        return None
    return 100.0 * sum(ops) / secs / PEAK_FLOPS
