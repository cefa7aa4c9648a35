"""Median of every sweep of the window, points handed in to detections
on the host (host clock)."""

from benchmark.common import percentile


def read(run):
    lat = run.get("latencies_s")
    return percentile(lat, 50) * 1e3 if lat else None
