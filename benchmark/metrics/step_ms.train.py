"""Median span of the train step per step, synchronised with the card
after each step in the unprofiled part of a traced window (rank 0)."""

from benchmark.common import percentile


def read(run):
    xs = run.get("spans", {}).get("step")
    return percentile(xs, 50) * 1e3 if xs else None
