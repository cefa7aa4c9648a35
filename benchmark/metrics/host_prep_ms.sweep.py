"""Median span of InferenceContext.get_inference_input_dict per sweep
(host preparation: voxelizer, planner, anchor mask), over the unprofiled
part of a traced window."""

from benchmark.common import percentile


def read(run):
    xs = run.get("spans", {}).get("host_prep")
    return percentile(xs, 50) * 1e3 if xs else None
