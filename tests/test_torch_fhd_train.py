"""car.fhd training through the port's entry points, with the GT-database
sampler, against the JAX package on the CPU.

Both packages build the same 4-frame KITTI tree (their fixtures, seed 0,
cars inside the clipped ranges below and the camera frustum), its
reduced point clouds and their own GT databases. Then, with the same
``np.random`` seeds on both sides (each sampler shuffles its database
when it is built, and samples, augments and shuffles points with the
global RNG, so seeding before the build and before each call gives
both the same draws):

* the databases' ``.bin`` files and the reduced clouds are equal byte
  for byte, the dbinfos field for field;
* ``DataBaseSamplerV2.sample_all`` gives exactly equal points, boxes,
  names, masks, difficulties and group ids: car.fhd's sampler (Car: 15,
  min 5 points, difficulty -1 removed), the same with a per-object
  global rotation, a multi-class group and ``random_crop``;
* ``prep_pointcloud`` with the sampler and training=True gives equal
  examples, key by key, tolerance 0: a car.fhd-shaped config (the
  sparse middle's ``plan_*`` rulebooks) and PointPillars' xyres_16
  topology (``emit_points`` and ``compact_targets``);
* from the same flax variables (``from_flax``), the first loss of the
  port's train step on a sampled batch is within 1e-4 relative of the
  JAX step's (fp32 sums in another order).

Then the port alone: ``train`` runs car.fhd's published config
(clipped to a [41, 512, 512] grid) for 2 steps and 1 resumed step with
the sampler, and ``evaluate`` returns the official AP; and
``python -m second_tpu_torch.create_data kitti_data_prep`` prepares a
tree.
"""

import copy
import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.builders import dbsampler_builder as jdbs
from second_tpu.builders import network_builder as jnb
from second_tpu.configs import loads_pipeline_config as jloads
from second_tpu.core import sample_ops as jsample_ops
from second_tpu.data import gt_database as jgt
from second_tpu.data import kitti_dataset as jkd
from second_tpu.data.preprocess import prep_pointcloud as jprep
from second_tpu.models import sparse_middle as jsm
from second_tpu.train import optimizer as jopt
from second_tpu.train.__main__ import example_convert
from second_tpu.train.state import TrainState as JaxTrainState
from second_tpu.train.state import make_train_step as jmake_train_step

import kitti_fixture as jfixture

from second_tpu_torch.builders import dbsampler_builder as tdbs
from second_tpu_torch.builders import network_builder as tnb
from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.data.kitti_dataset import KittiDataset
from second_tpu_torch.configs import load_pipeline_config
from second_tpu_torch.configs import loads_pipeline_config as tloads
from second_tpu_torch.core import preprocess as tprep_mod
from second_tpu_torch.core import sample_ops as tsample_ops
from second_tpu_torch.core.inference import example_to_device
from second_tpu_torch.create_data import nuscenes_data_prep
from second_tpu_torch.data import gt_database as tgt
from second_tpu_torch.data import kitti_dataset as tkd
from second_tpu_torch.data import merge_second_batch
from second_tpu_torch.tools import kitti_fixture as tfixture
from second_tpu_torch.train import optimizer as topt
from second_tpu_torch.train.__main__ import (
    _sparse_utilisation,
    evaluate,
    train,
)
from second_tpu_torch.train.state import make_train_step
from second_tpu_torch.utils.config_tool import change_detection_range
from second_tpu_torch.utils.from_flax import from_flax

from test_torch_pointpillars import SMALL_PP_CONFIG
from test_torch_slice import SMALL_FHD_CONFIG, random_variables

# the rows a KITTI frame's point buffer holds (the dataset's capacity)
POINTS_BUFFER = KittiDataset.PointsCapacity

REPO = Path(__file__).resolve().parent.parent
FRAMES = 4
# cars with centres in x [7, 15.48], y [-5.24, 5.24] (the fixture keeps
# 5 m off the ranges' ends), 4.6 m apart: inside the camera frustum and
# every clipped range below
SCENE = dict(num_cars=4, x_range=(2.0, 20.48), y_range=(-10.24, 10.24),
             min_gap=4.6)
# SMALL_FHD_CONFIG's topology over SMALL_PP_CONFIG's range: a
# [41, 128, 128] grid
FHD_RANGE = [0.0, -10.24, 20.48, 10.24]
FHD_VOXEL = [0.16, 0.16, 0.1]
FHD_VOXELS = 8000  # above the frames' ~6000 voxels
# car.fhd's published config clipped to a [41, 512, 512] grid
TRAIN_RANGE = [0.0, -12.8, 25.6, 12.8]
SAMPLER_SEED = 11


def _same(a, b, path="info"):
    """Nested dicts/lists/arrays equal, exactly."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same tree, reduced clouds and GT database, written by each
    package's own functions."""
    out = {}
    for name, fixture, kd, gt in (("port", tfixture, tkd, tgt),
                                  ("jax", jfixture, jkd, jgt)):
        root = tmp_path_factory.mktemp(f"fhd_{name}") / "kitti"
        ids = fixture.build_kitti_dir(root, num_frames=FRAMES, seed=0,
                                      scene_kwargs=SCENE)
        kd.create_kitti_info_file(str(root), train_img_ids=ids,
                                  val_img_ids=ids, test_img_ids=[])
        kd.create_reduced_point_cloud(str(root))
        gt.create_groundtruth_database(
            "KittiDataset", str(root),
            info_path=str(root / "kitti_infos_train.pkl"))
        out[name] = root
    return out


def test_gt_database_matches_jax(trees):
    port, jroot = trees["port"], trees["jax"]
    for sub in ("gt_database", "training/velodyne_reduced"):
        files = sorted(p.name for p in (port / sub).iterdir())
        assert files == sorted(p.name for p in (jroot / sub).iterdir()), sub
        assert files, sub
        for name in files:
            assert (port / sub / name).read_bytes() == (
                jroot / sub / name).read_bytes(), f"{sub}/{name}"
    with open(port / "kitti_dbinfos_train.pkl", "rb") as f, \
            open(jroot / "kitti_dbinfos_train.pkl", "rb") as g:
        infos, ref = pickle.load(f), pickle.load(g)
    _same(infos, ref, "dbinfos")
    assert len(infos["Car"]) == FRAMES * SCENE["num_cars"]


def _sampler_config(root, rot_range=(0.0, 0.0)):
    """car.fhd's train-reader sampler reading the database under
    ``root``, as the port's config and the JAX package's (parsed from the
    same text)."""
    cfg = load_pipeline_config(str(REPO / "configs" / "car.fhd.config"))
    sampler = cfg.train_input_reader.preprocess.database_sampler
    sampler.database_info_path = str(root / "kitti_dbinfos_train.pkl")
    sampler.global_random_rotation_range_per_object = list(rot_range)
    return sampler, jloads(cfg.to_text()).train_input_reader.preprocess \
        .database_sampler


def _group_db(root):
    """A database of 6 (car, trailer) groups, as
    ``tests/test_group_sampling.py`` fabricates it."""
    rng = np.random.RandomState(4)
    db_infos = {"car": [], "trailer": []}
    for g in range(6):
        base = rng.uniform(-20, 20, 2)
        for k, name in enumerate(("car", "trailer")):
            path = root / f"{name}_{g}.bin"
            (rng.randn(30, 4).astype(np.float32) * 0.5).tofile(str(path))
            box = np.array([base[0] + 4.0 * k, base[1], -1.0, 1.8, 4.5, 1.5,
                            rng.uniform(-np.pi, np.pi)])
            db_infos[name].append({
                "name": name, "path": path.name, "image_idx": g,
                "gt_idx": k, "box3d_lidar": box, "num_points_in_gt": 30,
                "difficulty": 0, "group_id": g})
    return db_infos


@pytest.mark.parametrize("case", ["cars", "cars_global_rot", "group", "crop"])
def test_sample_all_matches_jax(trees, tmp_path, case):
    port, jroot = trees["port"], trees["jax"]
    with open(port / "kitti_infos_train.pkl", "rb") as f:
        info = pickle.load(f)[1]
    sensor = tkd.KittiDataset(
        root_path=str(port),
        info_path=str(port / "kitti_infos_train.pkl")).get_sensor_data(1)
    boxes = sensor["lidar"]["annotations"]["boxes"]
    names = sensor["lidar"]["annotations"]["names"]
    kwargs = {}
    if case == "group":
        roots = (tmp_path, tmp_path)
        db = _group_db(tmp_path)

        def build(ops):
            return ops.DataBaseSamplerV2(
                copy.deepcopy(db), groups=[{"car": 4, "trailer": 4}],
                rate=1.0, global_rot_range=[0.0, 0.0])

        samplers = []
        for ops in (tsample_ops, jsample_ops):
            np.random.seed(SAMPLER_SEED)
            samplers.append(build(ops))
        names = np.array(["car"] * len(boxes))
        kwargs["gt_group_ids"] = np.arange(len(boxes))
    else:
        roots = (port, jroot)
        rot = (-0.78539816, 0.78539816) if case == "cars_global_rot" else (
            0.0, 0.0)
        tcfg, _ = _sampler_config(port, rot)
        _, jcfg = _sampler_config(jroot, rot)
        samplers = []
        for builder, cfg in ((tdbs, tcfg), (jdbs, jcfg)):
            np.random.seed(SAMPLER_SEED)
            samplers.append(builder.build(cfg))
        if case == "crop":
            calib = info["calib"]
            kwargs["calib"] = {"rect": calib["R0_rect"],
                               "Trv2c": calib["Tr_velo_to_cam"],
                               "P2": calib["P2"]}
    results = []
    for sampler, root in zip(samplers, roots):
        np.random.seed(SAMPLER_SEED + 1)
        results.append([sampler.sample_all(
            str(root), boxes.copy(), names.copy(), 4,
            random_crop=case == "crop", **copy.deepcopy(kwargs))
            for _ in range(3)])
    for i, (res, ref) in enumerate(zip(*results)):
        assert res is not None and len(res["gt_names"]) > 0, i
        _same(res, ref, f"{case} call {i}")
    if case == "group":
        gids, counts = np.unique(results[0][0]["group_ids"],
                                 return_counts=True)
        assert (counts == 2).all() and gids.min() > len(boxes) - 1


def _fhd_config(root):
    """SMALL_FHD_CONFIG over the tree's cars ([41, 128, 128], capacity
    ``FHD_VOXELS``) with car.fhd's sampler reading the tree's
    database."""
    cfg = tloads(SMALL_FHD_CONFIG)
    cfg.model.second.voxel_generator.voxel_size = FHD_VOXEL
    change_detection_range(cfg.model.second, FHD_RANGE)
    for reader in (cfg.train_input_reader, cfg.eval_input_reader):
        reader.preprocess.max_number_of_voxels = FHD_VOXELS
    return _with_sampler(cfg, root)


def _pp_config(root):
    return _with_sampler(tloads(SMALL_PP_CONFIG), root)


def _with_sampler(cfg, root):
    reader = cfg.train_input_reader
    reader.dataset.dataset_class_name = "KittiDataset"
    reader.dataset.kitti_root_path = str(root)
    reader.dataset.kitti_info_path = str(root / "kitti_infos_train.pkl")
    reader.preprocess.database_sampler = _sampler_config(root)[0]
    reader.preprocess.remove_points_after_sample = True
    reader.preprocess.sample_importance = 1.0
    return cfg


def _preps(cfg, jroot, **kwargs):
    """The port's prep of ``cfg``'s train reader and the JAX package's
    keywords for the same prep, each with its own sampler built from
    the same seed."""
    tparts = tnb.build_network(cfg, "cpu")
    jcfg = jloads(cfg.to_text())
    jcfg.train_input_reader.preprocess.database_sampler.database_info_path = (
        str(jroot / "kitti_dbinfos_train.pkl"))
    jparts = jnb.build_network(jcfg, use_banded=False)
    np.random.seed(SAMPLER_SEED)
    tprep = build_prep_func(cfg.train_input_reader, tparts, training=True,
                            **kwargs)
    assert tprep.keywords["db_sampler"] is not None
    np.random.seed(SAMPLER_SEED)
    jkw = dict(tprep.keywords)
    jkw.update(
        root_path=str(jroot),
        db_sampler=jdbs.build(
            jcfg.train_input_reader.preprocess.database_sampler),
        voxel_generator=jparts["voxel_generator"],
        target_assigner=jparts["target_assigner"],
        anchor_cache=jparts["anchor_cache"])
    if tprep.keywords["sparse_plan_scales"] is not None:
        jkw["sparse_plan_scales"] = jsm.plan_scales(
            "SpMiddleFHD", jparts["dense_shape"],
            cfg.train_input_reader.preprocess.max_number_of_voxels)
    return tparts, jparts, tprep, jkw


def _inputs(root):
    dataset = tkd.KittiDataset(root_path=str(root),
                               info_path=str(root / "kitti_infos_train.pkl"))
    return [dataset.get_sensor_data(i) for i in range(FRAMES)]


@pytest.mark.parametrize("model", ["fhd", "pp"])
def test_prep_with_sampler_matches_jax(trees, model):
    port, jroot = trees["port"], trees["jax"]
    if model == "fhd":
        _, _, tprep, jkw = _preps(_fhd_config(port), jroot)
    else:
        _, _, tprep, jkw = _preps(_pp_config(port), jroot,
                                  emit_points=POINTS_BUFFER,
                                  compact_targets=True)
    sampled = 0
    for i, input_dict in enumerate(_inputs(port)):
        np.random.seed(100 + i)
        tex = tprep(input_dict=copy.deepcopy(input_dict))
        np.random.seed(100 + i)
        jex = jprep(input_dict=copy.deepcopy(input_dict), **jkw)
        assert sorted(k for k in tex if k != "metrics") == sorted(
            k for k in jex if k != "metrics")
        sampled += len(tex["gt_names"]) - len(
            input_dict["lidar"]["annotations"]["names"])
        for key in tex:
            if key in ("metrics", "calib"):
                continue
            np.testing.assert_array_equal(
                tex[key], np.asarray(jex[key]).astype(tex[key].dtype),
                err_msg=f"frame {i} {key}")
        if model == "fhd":
            assert any(k.startswith("plan_") for k in tex)
            assert (tex["labels"] > 0).any()
        else:
            assert "points" in tex and int(tex["pos_count"][0]) > 0
    assert sampled > 0, "the sampler must paste objects into the frames"


def test_first_sampled_loss_matches_jax(trees):
    port, jroot = trees["port"], trees["jax"]
    cfg = _fhd_config(port)
    tparts, jparts, tprep, _ = _preps(cfg, jroot)
    np.random.seed(7)
    batch = merge_second_batch([tprep(input_dict=d)
                                for d in _inputs(port)[:2]])
    assert (batch["labels"] > 0).sum() > 0
    cap = cfg.train_input_reader.preprocess.max_number_of_voxels
    variables = random_variables(jparts["net"], cap, seed=3)

    tx, _, _ = jopt.build(cfg.train_config.optimizer, cfg.train_config.steps)
    jstate = JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables), tx)
    jex = {k: jnp.asarray(v) for k, v in example_convert(batch).items()}
    _, jm = jmake_train_step(jparts["net"], jparts["spec"], tx)(jstate, jex)

    net = tparts["net"]
    net.load_state_dict(from_flax(variables), strict=True)
    opt, lr_fn, mom_fn = topt.build(cfg.train_config.optimizer,
                                    cfg.train_config.steps,
                                    list(net.parameters()))
    m = make_train_step(net, tparts["spec"], opt, lr_fn, mom_fn)(
        example_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert int(m["num_pos"]) == int(jm["num_pos"]) > 0


def _train_config(root, path, steps):
    """car.fhd's published config over the tree: the range clipped to a
    [41, 512, 512] grid, 12000 voxels, batch 2, its sampler reading the
    tree's database."""
    cfg = load_pipeline_config(str(REPO / "configs" / "car.fhd.config"))
    change_detection_range(cfg.model.second, TRAIN_RANGE)
    for reader, split in ((cfg.train_input_reader, "train"),
                          (cfg.eval_input_reader, "val")):
        reader.dataset.kitti_root_path = str(root)
        reader.dataset.kitti_info_path = str(
            root / f"kitti_infos_{split}.pkl")
        reader.batch_size = 2
        reader.preprocess.max_number_of_voxels = 12000
        reader.preprocess.num_workers = 0
    cfg.train_input_reader.preprocess.database_sampler.database_info_path = (
        str(root / "kitti_dbinfos_train.pkl"))
    cfg.train_config.steps = steps
    cfg.train_config.save_checkpoints_secs = 3600
    path.write_text(cfg.to_text())
    return str(path)


def test_train_resume_evaluate_fhd_on_cpu(tmp_path):
    """2 steps of car.fhd through ``train`` with the sampler, 1 more
    resumed from the checkpoint, then ``evaluate`` (rotated NMS) into
    the official AP. Two frames: one batch per epoch."""
    root = tmp_path / "kitti"
    ids = tfixture.build_kitti_dir(root, num_frames=2, seed=1,
                                   scene_kwargs=SCENE)
    tkd.create_kitti_info_file(str(root), ids, ids)
    tgt.create_groundtruth_database(
        "KittiDataset", str(root), str(root / "kitti_infos_train.pkl"))
    model_dir = tmp_path / "model"
    np.random.seed(0)
    train(_train_config(root, tmp_path / "fhd.config", 2), str(model_dir),
          display_step=1, device="cpu")
    train(_train_config(root, tmp_path / "fhd3.config", 3), str(model_dir),
          resume=True, display_step=1, device="cpu")
    records = [json.loads(line) for line in
               (model_dir / "log.json.lst").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    for r in records:
        assert np.isfinite(r["runtime.loss"])
        assert 0 < r["runtime.sparse_util_max"] <= 1.0
    assert (model_dir / "voxelnet-3.ckpt").is_file()
    text = (model_dir / "log.txt").read_text()
    assert text.count("Evaluation official") == 2
    assert "OVERFLOW" not in text
    res = evaluate(str(tmp_path / "fhd3.config"), str(model_dir),
                   result_path=str(tmp_path / "eval"), device="cpu")
    assert "official" in res["results"]
    assert "3d   AP:" in res["results"]["official"]
    payload = torch.load(model_dir / "voxelnet-3.ckpt", weights_only=True)
    assert any(k.startswith("middle_feature_extractor.")
               and k.endswith("running_var") for k in payload["net"])


class _Log:
    def __init__(self):
        self.lines = []

    def log_text(self, text, step):
        self.lines.append((step, text))


def test_sparse_overflow_is_reported():
    log = _Log()
    fits = np.array([[[100, 200], [50, 128]], [[120, 200], [60, 128]]])
    assert _sparse_utilisation(fits, log, 1) == 0.6
    assert log.lines == []
    over = fits.copy()
    over[1, 1, 0] = 160
    assert _sparse_utilisation(over, log, 2) == 1.25
    assert len(log.lines) == 1 and "OVERFLOW" in log.lines[0][1]
    assert log.lines[0][0] == 2


def test_create_data_cli(tmp_path):
    """``python -m second_tpu_torch.create_data kitti_data_prep`` on a
    fixture tree with its own split files: infos, reduced clouds and the
    GT database with every car."""
    root = tmp_path / "kitti"
    ids = tfixture.build_kitti_dir(root, num_frames=2, seed=2)
    sets = tmp_path / "ImageSets"
    sets.mkdir()
    for split in ("train", "val"):
        (sets / f"{split}.txt").write_text("\n".join(map(str, ids)) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "second_tpu_torch.create_data",
         "kitti_data_prep", f"--root_path={root}", f"--imageset_dir={sets}"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_infos_trainval.pkl", "kitti_dbinfos_train.pkl"):
        assert (root / name).is_file(), name
    assert not (root / "kitti_infos_test.pkl").exists()
    assert len(list((root / "training" / "velodyne_reduced").iterdir())) == 2
    with open(root / "kitti_dbinfos_train.pkl", "rb") as f:
        db = pickle.load(f)
    assert len(db["Car"]) == 2 * 4
    assert len(list((root / "gt_database").iterdir())) == 2 * 4
    assert tkd.read_imageset_file(tkd.IMAGESETS / "train.txt")[:2] == [0, 3]
    # its infos need the nuScenes devkit, which this host lacks
    with pytest.raises(ImportError, match="nuScenes devkit"):
        nuscenes_data_prep(str(root), "v1.0-mini")


def test_batch_sampler_draws_each_item_once_per_epoch_across_threads():
    """The loader's threads share one sampler: drawing one item at a time
    from 8 threads that start together, with the interpreter switching
    threads every microsecond, every item still comes out once per epoch
    (a lost update of the cursor would repeat or skip items)."""
    items, epochs, threads = list(range(13)), 10000, 8
    sampler = tprep_mod.BatchSampler(items)
    per_thread = len(items) * epochs // threads
    assert per_thread * threads == len(items) * epochs
    drawn = [None] * threads
    start = threading.Barrier(threads)

    def work(i):
        start.wait()
        drawn[i] = [sampler.sample(1)[0] for _ in range(per_thread)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(sum(drawn, [])) == sorted(items * epochs)
