"""Median span of the prefetcher's next() per step (the loader's wait),
over the unprofiled part of a traced window (rank 0 across ranks)."""

from benchmark.common import percentile


def read(run):
    xs = run.get("spans", {}).get("fetch")
    return percentile(xs, 50) * 1e3 if xs else None
