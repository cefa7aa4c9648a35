"""Stage attribution (``benchmark/stages.py``) on a synthetic Chrome
trace, and the per-request host split on a registry snapshot."""

import json

import pytest

from benchmark import stages, trace
from second_tpu_torch.utils.timer import Span


def _range(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid}


def _launch(corr, ts, tid=1):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 2, "pid": 7, "tid": tid, "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr}}


def _trace():
    return [
        _range("bench.request", 0, 100),
        _range("bench.host_prep", 0, 40),
        _range("prep.plan", 5, 30),
        _launch(1, 10),
        _range("bench.device_path", 40, 60),
        _range("net.rpn", 45, 30),
        _range("inner", 50, 10),
        _launch(2, 47),
        _launch(3, 52),
        # inside net.rpn's time, on another thread: not net.rpn's
        _launch(4, 60, tid=2),
        # inside bench.device_path, outside every program span
        _launch(5, 90),
        _kernel("a", 1, 20, 10),
        _kernel("b", 2, 50, 20),
        _kernel("c", 3, 70, 5),
        _kernel("Memcpy HtoD", 4, 75, 5, cat="gpu_memcpy"),
        _kernel("d", 5, 92, 20),  # clipped at the window's end (100)
    ]


def test_attribution_by_correlation(tmp_path):
    ev = _trace()
    out = stages.attribute(ev)
    assert out["requests"] == 1
    s = out["stages_s"]
    assert s["prep.plan"] == pytest.approx(10e-6)
    assert s["net.rpn"] == pytest.approx(20e-6)
    assert s["inner"] == pytest.approx(5e-6)
    assert out["unattributed_s"] == pytest.approx((5 + 8) * 1e-6)
    top = {k: dict(v) for k, v in out["top_ops"].items()}
    assert top["net.rpn"] == pytest.approx({"b": 20e-6})
    assert top[None] == pytest.approx({"Memcpy HtoD": 5e-6, "d": 8e-6})
    # stage time plus the unattributed is the window's device-op time
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    kernels = sum(trace.reduce_trace(path)["kernels"].values())
    assert sum(s.values()) + out["unattributed_s"] == pytest.approx(kernels)
    assert out["device_s"] == pytest.approx(kernels)


def test_program_ranges_name_the_idle_gaps(tmp_path):
    """The existing labeller names a gap by the program's stage."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    gaps = dict(trace.reduce_trace(path)["idle_gaps"])
    assert gaps["host_prep/prep.plan"] == pytest.approx(20e-6)
    assert stages.prep_labelled_share(list(gaps.items())) < 100.0
    assert stages.prep_labelled_share([["host_prep/prep.plan", 1.0],
                                       ["device_path/net.rpn", 2.0]]) == 100
    assert stages.prep_labelled_share([["other", 1.0]]) is None


def test_host_split_per_request():
    ms = 1_000_000
    snap = {"spans": [Span("prep.voxelize", 0, 4 * ms, 1, 1),
                      Span("prep.pack", 4 * ms, 5 * ms, 1, 1),
                      Span("upload", 6 * ms, 7 * ms, 1, 1),
                      Span("net.rpn", 7 * ms, 9 * ms, 1, 1),
                      Span("train_step", 0, ms, None, 1),
                      Span("prep.voxelize", 0, 2 * ms, 2, 2)],
            "counts": {1: {"upload_bytes": 3_000_000,
                           "sparse_rows_active": 25,
                           "sparse_rows_capacity": 100},
                       2: {"upload_bytes": 1_000_000},
                       None: {"upload_bytes": 5}}}
    reqs = stages.per_request(snap)
    assert set(reqs) == {1, 2}
    assert reqs[1]["s"]["prep.voxelize"] == pytest.approx(4e-3)
    out = stages.host_split([reqs[1], reqs[2]], [5e-3, 3e-3], [4e-3, 1e-3])
    assert out["stage_ms"]["prep.voxelize"] == pytest.approx(3.0)
    assert out["stage_ms"]["net.rpn"] == pytest.approx(1.0)
    assert out["prep_sum_ms"] == pytest.approx(3.5)
    assert out["device_host_sum_ms"] == pytest.approx(1.5)
    assert out["host_prep_ms"] == pytest.approx(4.0)
    assert out["upload_mb"] == pytest.approx(2.0)
    assert out["sparse_fill_pct"] == pytest.approx(25.0)
    empty = stages.host_split([{"s": {}, "counts": {}}], [1e-3], [1e-3])
    assert empty["upload_mb"] is None and empty["sparse_fill_pct"] is None
