"""95th percentile of every sweep of the window (host clock)."""

from benchmark.common import percentile


def read(run):
    lat = run.get("latencies_s")
    return percentile(lat, 95) * 1e3 if lat else None
