"""The route of an example (``second_tpu_torch.builders.route``): what a
request, a training loader and an evaluation loader ship for each repo
config and each ``device_voxelize``, and the request's host batch at the
benchmark's published sizes.

* The table: for car.fhd, all.fhd, PointPillars xyres_16 and the
  nuScenes multi-head network, under "auto", True and False, and for
  each use, the route's decision (points or host voxels, the C++ plan,
  the request's linear-id sort, the flat pillar path) and the example
  its prep gives on a small synthetic frame: its keys, its buffers'
  rows (the reader's capacities), its compact targets.
* The request's host batch of the benchmark's three configs: its keys,
  dtypes, shapes and upload bytes exactly, and for car_fhd and
  pointpillars on two sweeps of the ``sweep`` mix, the plain
  reference's host arrays exactly (``benchmark/reference``).
* The host voxelizer runs only where something reads its voxels: a
  points example without an anchor mask skips it and ships no
  "num_voxels"; PointPillars' mask and a voxel route keep it.
* Serving loads nothing of the training package.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.gen import nusc_scenes, scenes
from benchmark.reference import judge, pipeline
from second_tpu.data.preprocess import prep_pointcloud as jprep
from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.builders.network_builder import build_network
from second_tpu_torch.builders.route import make_route, points_capacity
from second_tpu_torch.configs import load_pipeline_config, schema
from second_tpu_torch.core.inference import InferenceContext, example_convert
from second_tpu_torch.utils import timer

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"car.fhd": "configs/car.fhd.config",
           "all.fhd": "configs/all.fhd.config",
           "xyres_16": "configs/pointpillars/car/xyres_16.config",
           "mhead": "configs/nuscenes/all.pp.mhead.config"}
SPARSE = ("car.fhd", "all.fhd")
DEVICE_VOXELIZE = ("auto", True, False)
USES = ("request", "train", "eval")

# the routes, as (use, device_voxelize) -> what the example ships: a
# sparse middle's requests ship points on any true value ("auto" too)
# and otherwise host voxels sorted for the device's planner; its loaders
# ship the C++ plan unless told to ship points. A PointPillars network
# (a PillarFeatureNet on a dense middle) serves requests on the flat
# pillar path whatever it is given, trains on points unless told not to,
# and evaluates on the flat pillar path unless told to ship voxels.
TABLE = {
    "sparse": {
        ("request", "auto"): "points", ("request", True): "points",
        ("request", False): "voxels, sorted",
        ("train", "auto"): "voxels, plan", ("train", True): "points",
        ("train", False): "voxels, plan",
        ("eval", "auto"): "voxels, plan", ("eval", True): "points",
        ("eval", False): "voxels, plan"},
    "pillars": {
        ("request", "auto"): "points, flat",
        ("request", True): "points, flat",
        ("request", False): "points, flat",
        ("train", "auto"): "points", ("train", True): "points",
        ("train", False): "voxels",
        ("eval", "auto"): "points, flat", ("eval", True): "points, flat",
        ("eval", False): "voxels"},
}


@pytest.fixture(scope="module")
def nets():
    """Each repo config (its train reader without the GT-database
    sampler, whose database is not here) and its network, built once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for name, path in CONFIGS.items():
        cfg = load_pipeline_config(str(REPO / path))
        cfg.train_input_reader.preprocess.database_sampler = (
            schema.Sampler.from_raw({}))
        out[name] = (cfg, build_network(cfg, "cpu"))
    yield out
    torch.set_num_threads(threads)


def _frame(seed, n=3000):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(0, 40, n), rng.uniform(-20, 20, n),
                     rng.uniform(-2, 0.5, n), rng.uniform(0, 1, n)],
                    1).astype(np.float32)


def _input(use):
    lidar = {"type": "lidar", "points": _frame(USES.index(use))}
    if use == "train":
        lidar["annotations"] = {
            "boxes": np.array([[10.0, 2.0, -1.0, 1.6, 3.9, 1.56, 0.3],
                               [20.0, -5.0, -1.0, 1.6, 3.9, 1.56, 1.2]],
                              np.float32),
            "names": np.array(["Car", "Car"])}
    return {"lidar": lidar, "metadata": {"image_idx": 0}}


def _label(route):
    words = ["points" if route.ships_points else "voxels"]
    if route.plan_scales is not None:
        words.append("plan")
    if route.sort_shape is not None:
        words.append("sorted")
    if route.flat_pp:
        words.append("flat")
    return ", ".join(words)


@pytest.mark.parametrize("use", USES)
@pytest.mark.parametrize("device_voxelize", DEVICE_VOXELIZE)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_route_table(nets, name, device_voxelize, use):
    cfg, parts = nets[name]
    reader = cfg.train_input_reader if use == "train" else (
        cfg.eval_input_reader)
    route = make_route(parts, reader, use, device_voxelize)
    want = TABLE["sparse" if name in SPARSE else "pillars"][
        use, device_voxelize]
    assert _label(route) == want
    assert route.compact_targets == (use == "train" and route.ships_points)
    assert route.points_capacity == points_capacity(reader)
    assert route.max_voxels == reader.preprocess.max_number_of_voxels
    assert (route.voxelizer is not None) == route.ships_points

    np.random.seed(0)
    prep = build_prep_func(reader, parts, training=use == "train",
                           route=route)
    example = prep(input_dict=_input(use))
    if use == "request":
        route.sort_request(example)
    plan = sorted(k for k in example if k.startswith("plan_"))
    assert bool(plan) == (route.plan_scales is not None)
    if route.ships_points:
        assert "voxels" not in example and "coordinates" not in example
        assert example["points"].shape[0] == route.points_capacity
        assert 0 < example["points_count"][0] <= route.points_capacity
    else:
        assert "points" not in example
        assert example["voxels"].shape[0] == route.max_voxels
    if use == "train":
        assert ("labels_i8" in example) == route.compact_targets
        assert ("labels" in example) != route.compact_targets
    if route.sort_shape is not None:
        d, h, w = route.sort_shape
        coords = example["coordinates"][:int(example["num_voxels"][0])]
        lin = (coords[:, 0].astype(np.int64) * h + coords[:, 1]) * w + (
            coords[:, 2])
        assert len(lin) > 0 and (np.diff(lin) > 0).all()


def test_route_refuses_other_values(nets):
    cfg, parts = nets["car.fhd"]
    with pytest.raises(ValueError, match="device_voxelize"):
        make_route(parts, cfg.eval_input_reader, "eval", "yes")
    with pytest.raises(ValueError, match="use"):
        make_route(parts, cfg.eval_input_reader, "serve")


# the request's host batch of each benchmark config at its published
# size: its arrays' dtypes and shapes, and the bytes it uploads
HOST_BATCH = {
    "car_fhd": ({"voxels": ("float32", (1, 40000, 5, 4)),
                 "num_points": ("int32", (1, 40000)),
                 "coordinates": ("int32", (1, 40000, 3)),
                 "num_voxels": ("int64", (1, 1)),
                 "anchors": ("float32", (1, 70400, 7))}, 5811200),
    "pointpillars": ({"num_voxels": ("int64", (1, 1)),
                      "anchors": ("float32", (1, 107136, 7)),
                      "anchors_mask": ("bool", (1, 107136)),
                      "points": ("float32", (1, 32768, 4)),
                      "points_count": ("int32", (1, 1))}, 3631236),
    "nusc_mhead": ({"anchors": ("float32", (1, 1124000, 7)),
                    "points": ("float32", (1, 393216, 4)),
                    "points_count": ("int32", (1, 1))}, 37763460),
}
SEED = 2 ** 31 + 99


@pytest.mark.parametrize("name", sorted(HOST_BATCH))
def test_request_host_batch(name):
    cfg = common.load_config(name)
    ctx = InferenceContext()
    ctx.build(str(common.ROOT / cfg["repo_config"]), "cpu",
              **cfg["build"])
    arrays, upload = HOST_BATCH[name]
    if name == "nusc_mhead":
        mix = common.load_mix("nusc_sweep")
        frames = nusc_scenes.frame_pool(SEED, dict(mix, pool=1))
        info = {"token": "t"}
    else:
        frames = scenes.sweep_pool(SEED, dict(common.load_mix("sweep"),
                                              pool=2))
        info = {}
    for points in frames:
        ex = ctx.get_inference_input_dict(info, points)
        assert set(ex) == set(arrays) | {"metadata"}
        assert {k: (str(ex[k].dtype), ex[k].shape) for k in arrays} == (
            arrays)
        assert sum(v.nbytes for v in example_convert(ex).values()) == (
            upload)
        if name != "nusc_mhead":
            ref, _ = pipeline.host_example(cfg["model"], points)
            assert judge.prep_mismatch(ex, ref) == 0


# (config, use, device_voxelize) -> whether the host voxelizer runs: a
# points route reads host voxels only for the anchor mask, a voxel
# route ships them
HOST_VOXELIZER = {
    "mhead request": ("mhead", "request", "auto", False),
    "car.fhd points train": ("car.fhd", "train", True, False),
    "xyres_16 request": ("xyres_16", "request", "auto", True),
    "car.fhd voxel request": ("car.fhd", "request", False, True),
}


def _prep_counted(prep, use, **kwargs):
    """``prep`` of ``_input(use)`` at np.random seed 0, as one request
    with collection on: (the example, its counts)."""
    was = timer.collect(True)
    timer.reset()
    try:
        rid = timer.new_request()
        with timer.request(rid):
            np.random.seed(0)
            example = prep(input_dict=_input(use), **kwargs)
        return example, timer.snapshot()["counts"].get(rid, {})
    finally:
        timer.collect(was)
        timer.reset()


@pytest.mark.parametrize("case", sorted(HOST_VOXELIZER))
def test_host_voxelizer_runs_only_where_read(nets, case, monkeypatch):
    """A points route without an anchor mask never calls the host
    voxelizer, counts 0 under "host_voxelized" and ships no
    "num_voxels"; its points, counts and anchors are those of the same
    prep with the mask on (threshold 0, which voxelizes) bit for bit.
    PointPillars' mask and a voxel route call it once, count 1, and give
    the JAX package's example key for key."""
    name, use, device_voxelize, voxelizes = HOST_VOXELIZER[case]
    cfg, parts = nets[name]
    reader = cfg.train_input_reader if use == "train" else (
        cfg.eval_input_reader)
    route = make_route(parts, reader, use, device_voxelize)
    prep = build_prep_func(reader, parts, training=use == "train",
                           route=route)
    assert (prep.keywords["anchor_area_threshold"] >= 0) == (
        route.ships_points and voxelizes)
    np.random.seed(0)
    jex = jprep(input_dict=_input(use), **prep.keywords)
    masked, masked_counts = _prep_counted(prep, use,
                                          anchor_area_threshold=0)
    assert masked_counts["host_voxelized"] == 1

    gen = parts["voxel_generator"]
    calls = []

    def generate_multi_gpu(*args, **kwargs):
        calls.append(args)
        if not voxelizes:
            raise AssertionError("the host voxelizer ran")
        return type(gen).generate_multi_gpu(gen, *args, **kwargs)

    monkeypatch.setattr(gen, "generate_multi_gpu", generate_multi_gpu)
    example, counts = _prep_counted(prep, use)
    monkeypatch.undo()
    assert len(calls) == int(voxelizes)
    assert counts["host_voxelized"] == int(voxelizes)
    # the JAX package's example carries its timings under "metrics"
    want = set(jex) - {"metrics"} - (set() if voxelizes else {"num_voxels"})
    assert set(example) == want
    for key in sorted(want - {"gt_names"}):
        np.testing.assert_array_equal(example[key], np.asarray(jex[key]),
                                      err_msg=key)
        assert example[key].dtype == np.asarray(jex[key]).dtype, key
    if not voxelizes:
        assert set(masked) - set(example) == {"num_voxels", "anchors_mask"}
        for key in ("points", "points_count", "anchors"):
            assert example[key].dtype == masked[key].dtype, key
            np.testing.assert_array_equal(example[key], masked[key],
                                          err_msg=key)


def test_serving_loads_nothing_of_training():
    code = ("import sys, second_tpu_torch.core.inference; print(sorted(m "
            "for m in sys.modules if m.startswith('second_tpu_torch.train')"
            "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
