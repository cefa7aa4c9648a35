"""Median span of InferenceContext.inference per sweep (H2D, network,
predict, D2H of the detections), over the unprofiled part of a traced
window."""

from benchmark.common import percentile


def read(run):
    xs = run.get("spans", {}).get("device_path")
    return percentile(xs, 50) * 1e3 if xs else None
