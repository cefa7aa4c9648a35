"""The port's stage spans and counts (``second_tpu_torch/utils/timer.py``)
on the CPU, through ``InferenceContext`` on the tests' small car.fhd
(host voxels sorted by linear id, rulebooks built on the device),
PointPillars, nuScenes multi-head and nuScenes residual sparse configs,
and through ``evaluate``.

Off, nothing is kept and no profiler range opens; on, every request
records each of its stages once, in program order and without nesting
(but the multi-head network's ``net.heads``, inside ``net.rpn``, and the
residual middle's ``net.middle.wide``, inside ``net.middle``), all under
its own id, with the bytes it uploads (not the anchors: the device
reads its resident copy, "anchors_resident" 1), the sparse rows of the
device's stage counts (active, capacity and the overflow beyond it)
and, on the flat pillar path, the points shipped and the buffer's rows;
under ``torch.profiler`` the stages are ``user_annotation`` ranges on
the caller's thread. Collection adds no host sync.
"""

import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from second_tpu_torch import configs as port_configs
from second_tpu_torch.configs import loads_pipeline_config as tloads
from second_tpu_torch.core.inference import InferenceContext, example_convert
from second_tpu_torch.data import kitti_dataset as tkd
from second_tpu_torch.tools import kitti_fixture as tfixture
from second_tpu_torch.train.__main__ import evaluate, train
from second_tpu_torch.utils import timer

from benchmark.tests.small_mhead import small_frame, small_mhead_config
from benchmark.tests.small_res8x import small_res8x_frame
from test_torch_pointpillars import SMALL_PP_CONFIG, small_pp_points
from test_torch_res8x import build_small_res8x
from test_torch_slice import SMALL_FHD_CONFIG, small_fhd_points

HOST = {"fhd": ["prep.voxelize", "prep.anchor_mask", "prep.plan",
                "prep.pack"],
        "pp": ["prep.voxelize", "prep.anchor_mask", "prep.pack"]}
DEVICE = {"fhd": ["upload", "net.encode", "net.middle", "net.rpn",
                  "net.predict"],
          "pp": ["upload", "net.encode", "net.rpn", "net.predict"]}
POINTS = {"fhd": small_fhd_points, "pp": small_pp_points}


@pytest.fixture(scope="module")
def contexts():
    out = {}
    for name, text in (("fhd", SMALL_FHD_CONFIG), ("pp", SMALL_PP_CONFIG)):
        ctx = InferenceContext()
        ctx.build(port_configs.loads_pipeline_config(text), device="cpu")
        ctx.init_random(0)
        out[name] = ctx
    return out


@pytest.fixture(autouse=True)
def collection_off():
    was = timer.collect(False)
    timer.reset()
    yield
    timer.collect(was)
    timer.reset()


def _request(ctx, points):
    batch = ctx.get_inference_input_dict({}, points)
    return batch, ctx.inference(batch)


@pytest.mark.parametrize("model", ["fhd", "pp"])
def test_off_records_nothing_and_opens_no_range(contexts, model,
                                                monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    batch, _ = _request(contexts[model], POINTS[model]())
    assert timer.REQUEST_KEY not in batch
    assert timer.snapshot() == {"spans": [], "counts": {}}
    assert opened == []
    assert timer.span("a") is timer.span("b")
    assert timer.new_request() is None


@pytest.mark.parametrize("model", ["fhd", "pp"])
def test_each_request_records_its_stages_once(contexts, model):
    ctx = contexts[model]
    timer.collect(True)
    batches = [_request(ctx, POINTS[model](seed))[0] for seed in (0, 1)]
    snap = timer.snapshot()
    rids = [b[timer.REQUEST_KEY] for b in batches]
    assert len(set(rids)) == 2
    assert {s.request for s in snap["spans"]} == set(rids)
    for rid, batch in zip(rids, batches):
        spans = sorted((s for s in snap["spans"] if s.request == rid),
                       key=lambda s: s.start_ns)
        # program order, one span per stage, none inside another
        assert [s.name for s in spans] == HOST[model] + DEVICE[model]
        for a, b in zip(spans, spans[1:]):
            assert a.start_ns <= a.end_ns <= b.start_ns
        counts = snap["counts"][rid]
        # both voxelize on the host: car.fhd ships voxels, PointPillars'
        # anchor mask reads them
        assert counts["host_voxelized"] == 1
        host = example_convert(batch)
        assert counts["anchors_resident"] == 1
        assert counts["upload_bytes"] == sum(
            v.nbytes for k, v in host.items() if k != "anchors")
        if model == "fhd":
            assert not any(k.startswith("plan_") for k in host)
            # the device's stage counts, read again with collection off
            was = timer.collect(False)
            active = ctx._run(batch)[2].numpy()
            timer.collect(was)
            assert counts["sparse_rows_active"] == active[..., 0].sum()
            assert counts["sparse_rows_capacity"] == active[..., 1].sum()
            assert counts["sparse_rows_active"] > 0
            assert counts["sparse_rows_overflow"] == 0
        else:
            assert set(counts) == {"upload_bytes", "anchors_resident",
                                   "points_shipped", "points_capacity",
                                   "host_voxelized"}
            assert counts["points_shipped"] == batch["points_count"][0, 0]
            assert counts["points_capacity"] == ctx.route.points_capacity
    timer.reset()
    assert timer.snapshot() == {"spans": [], "counts": {}}


def test_stages_are_ranges_on_the_callers_thread(contexts, tmp_path):
    ctx = contexts["fhd"]
    points = small_fhd_points()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with torch.profiler.record_function("caller"):
            _request(ctx, points)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (caller,) = [e for e in events if e["name"] == "caller"]
    names = Counter(e["name"] for e in events)
    for name in HOST["fhd"] + DEVICE["fhd"]:
        assert names[name] == 1, name
    for e in events:
        if e["name"] != "caller":
            assert e["tid"] == caller["tid"], e["name"]
            assert caller["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= caller["ts"] + caller["dur"]
    # collection stayed off: the ranges are the profiler's alone
    assert timer.snapshot()["spans"] == []


def test_loader_threads_keep_their_requests_apart(contexts):
    ctx = contexts["pp"]
    timer.collect(True)
    made = {}
    errors = []

    def loader(k):
        try:
            made[k] = [(threading.get_ident(),
                        ctx.get_inference_input_dict(
                            {}, small_pp_points(10 * k + i)))
                       for i in range(3)]
        except Exception as err:  # surfaced below
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=loader, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    # the device half of one request runs on this thread
    tid, batch = made[0][0]
    ctx.inference(batch)
    spans = timer.snapshot()["spans"]
    for k in range(2):
        for tid, batch in made[k]:
            rid = batch[timer.REQUEST_KEY]
            mine = [s for s in spans if s.request == rid]
            assert sorted(s.name for s in mine if s.thread == tid) == sorted(
                HOST["pp"])
            others = [s.name for s in mine if s.thread != tid]
            assert others == (DEVICE["pp"] if batch is made[0][0][1]
                              else [])
    assert len({b[timer.REQUEST_KEY] for k in made for _, b in made[k]}) == 6


def test_evaluate_measure_time_logs_regions_and_stages(tmp_path, capsys):
    root = tmp_path / "kitti"
    ids = tfixture.build_kitti_dir(root, num_frames=2, seed=0)
    tkd.create_kitti_info_file(str(root), train_img_ids=ids,
                               val_img_ids=ids)
    cfg = tloads(SMALL_PP_CONFIG)
    for reader, split in ((cfg.train_input_reader, "train"),
                          (cfg.eval_input_reader, "val")):
        reader.dataset.dataset_class_name = "KittiDataset"
        reader.dataset.kitti_root_path = str(root)
        reader.dataset.kitti_info_path = str(root / f"kitti_infos_{split}.pkl")
        reader.batch_size = 2
        reader.preprocess.num_workers = 0
    cfg.train_config.steps = 1
    cfg.train_config.save_checkpoints_secs = 3600
    config = tmp_path / "pp.config"
    config.write_text(cfg.to_text())
    model_dir = tmp_path / "model"
    train(str(config), str(model_dir), display_step=1, measure_time=True,
          device="cpu")
    assert not timer.collecting()
    log = (model_dir / "log.txt").read_text()
    (line,) = [s for s in log.splitlines() if "avg_time_ms: " in s]
    for name in ("data_fetch", "train_step", "prep.voxelize",
                 "prep.anchor_mask", "net.encode", "net.rpn"):
        assert f"{name}=" in line, name
    capsys.readouterr()
    evaluate(str(config), str(model_dir), result_path=str(tmp_path / "e"),
             measure_time=True, device="cpu")
    out = capsys.readouterr().out
    (line,) = [s for s in out.splitlines() if s.startswith("avg_time_ms:")]
    for name in ("host_prep", "eval_step", "prep.voxelize",
                 "prep.anchor_mask", "net.encode", "net.rpn",
                 "net.predict"):
        assert f"'{name}'" in line, name
    assert not timer.collecting()


@pytest.fixture(scope="module")
def mhead(tmp_path_factory):
    """The nuScenes multi-head network on a small patch at its published
    widths (random weights) and a frame of (x, y, z, time lag) points."""
    cfg = small_mhead_config(tmp_path_factory.mktemp("mhead"))
    ctx = InferenceContext()
    ctx.build(cfg["repo_config"], device="cpu")
    ctx.init_random(0)
    return ctx, small_frame(cfg, np.random.default_rng(0))


def test_heads_span_nests_in_rpn_once_a_request(mhead):
    ctx, points = mhead
    timer.collect(True)
    batches = [ctx.get_inference_input_dict({"token": f"t{i}"}, points)
               for i in range(2)]
    for batch in batches:
        ctx.inference(batch)
    spans = timer.snapshot()["spans"]
    for batch in batches:
        mine = [s for s in spans if s.request == batch[timer.REQUEST_KEY]]
        names = Counter(s.name for s in mine)
        assert names["net.heads"] == 1 and names["net.rpn"] == 1
        (rpn,) = [s for s in mine if s.name == "net.rpn"]
        (heads,) = [s for s in mine if s.name == "net.heads"]
        assert rpn.start_ns <= heads.start_ns <= heads.end_ns <= rpn.end_ns
        assert heads.thread == rpn.thread


@pytest.mark.parametrize("model", ["fhd", "pp"])
def test_no_heads_span_on_rpnv2(contexts, model):
    timer.collect(True)
    _request(contexts[model], POINTS[model]())
    names = {s.name for s in timer.snapshot()["spans"]}
    assert "net.rpn" in names and "net.heads" not in names


@pytest.mark.parametrize("model", ["fhd", "pp", "mhead"])
def test_points_counted_on_flat_pillar_requests_only(contexts, mhead,
                                                     model):
    if model == "mhead":
        ctx, points = mhead
        info = {"token": "t"}
    else:
        ctx, points, info = contexts[model], POINTS[model](), {}
    timer.collect(True)
    batch = ctx.get_inference_input_dict(info, points)
    counts = timer.snapshot()["counts"].get(batch[timer.REQUEST_KEY], {})
    if model == "fhd":
        assert "points_shipped" not in counts
        assert "points_capacity" not in counts
    else:
        assert counts["points_shipped"] == batch["points_count"][0, 0] > 0
        assert counts["points_capacity"] == ctx.route.points_capacity == (
            batch["points"].shape[1])


@pytest.fixture(scope="module")
def res8x(tmp_path_factory):
    """The nuScenes residual sparse network on a small patch at its
    published widths (the benchmark's weights) and a frame of (x, y, z,
    time lag) points."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _, ctx, _ = build_small_res8x(tmp_path_factory.mktemp("res8x"))
    yield ctx, small_res8x_frame(np.random.default_rng([0, 1]))
    torch.set_num_threads(threads)


def _res8x_request(res8x):
    ctx, points = res8x
    batch = ctx.get_inference_input_dict({"token": "t"}, points)
    return batch, ctx.inference(batch)


def test_wide_span_nests_in_middle_once_a_request(res8x):
    """The residual middle's 128-channel stage runs under
    ``net.middle.wide``, inside ``net.middle``; the other stages are
    car.fhd's, and the stage counts come with the overflow (none)."""
    ctx, _ = res8x
    timer.collect(True)
    batches = [_res8x_request(res8x)[0] for _ in range(2)]
    snap = timer.snapshot()
    for batch in batches:
        rid = batch[timer.REQUEST_KEY]
        mine = sorted((s for s in snap["spans"] if s.request == rid),
                      key=lambda s: s.start_ns)
        assert [s.name for s in mine if s.name != "net.middle.wide"] == (
            HOST["fhd"] + DEVICE["fhd"])
        (wide,) = [s for s in mine if s.name == "net.middle.wide"]
        (middle,) = [s for s in mine if s.name == "net.middle"]
        assert middle.start_ns <= wide.start_ns <= wide.end_ns <= (
            middle.end_ns)
        assert wide.thread == middle.thread
        counts = snap["counts"][rid]
        was = timer.collect(False)
        active = ctx._run(batch)[2].numpy()
        timer.collect(was)
        assert counts["sparse_rows_active"] == active[..., 0].sum() > 0
        assert counts["sparse_rows_capacity"] == active[..., 1].sum()
        assert counts["sparse_rows_overflow"] == 0


@pytest.mark.parametrize("model", ["fhd", "pp", "mhead"])
def test_no_wide_span_on_narrow_networks(contexts, mhead, model):
    if model == "mhead":
        ctx, points = mhead
        info = {"token": "t"}
    else:
        ctx, points, info = contexts[model], POINTS[model](), {}
    timer.collect(True)
    ctx.inference(ctx.get_inference_input_dict(info, points))
    names = {s.name for s in timer.snapshot()["spans"]}
    assert "net.rpn" in names and "net.middle.wide" not in names


def test_overflow_counts_the_sites_beyond_capacity(res8x, monkeypatch):
    """With capacities cut below the frame's active sets, the request
    counts each stage's sites beyond its capacity, summed, as the
    device's stage counts give them."""
    ctx, _ = res8x
    monkeypatch.setattr(type(ctx.parts["net"].middle_feature_extractor),
                        "capacity_factors", (0.5, 0.5, 0.5, 0.5))
    timer.collect(True)
    batch, _ = _res8x_request(res8x)
    counts = timer.snapshot()["counts"][batch[timer.REQUEST_KEY]]
    timer.collect(False)
    active = ctx._run(batch)[2].numpy()
    over = np.maximum(active[..., 0] - active[..., 1], 0).sum()
    assert over > 0
    assert counts["sparse_rows_overflow"] == over


def test_wide_stage_off_records_nothing_and_opens_no_range(res8x,
                                                           monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    batch, _ = _res8x_request(res8x)
    assert timer.REQUEST_KEY not in batch
    assert timer.snapshot() == {"spans": [], "counts": {}}
    assert opened == []


def test_collection_adds_no_host_sync(contexts, mhead, res8x, monkeypatch):
    """The same calls that read a tensor back to the host (``item``,
    ``tolist``, ``cpu``, ``numpy``, truth values) with collection on as
    with it off, on the multi-head, PointPillars and residual sparse
    requests."""
    calls = Counter()
    for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                 "__int__", "__float__"):
        inner = getattr(torch.Tensor, name)

        def wrapped(self, *a, _inner=inner, _name=name, **k):
            calls[_name] += 1
            return _inner(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    ctx, points = mhead
    runs = [(ctx, points, {"token": "t"}),
            (contexts["pp"], POINTS["pp"](), {}),
            (res8x[0], res8x[1], {"token": "t"})]
    seen = {}
    for on in (False, True):
        timer.collect(on)
        calls.clear()
        for c, pts, info in runs:
            c.inference(c.get_inference_input_dict(info, pts))
        seen[on] = dict(calls)
    assert seen[True] == seen[False]
    assert timer.snapshot()["spans"]
