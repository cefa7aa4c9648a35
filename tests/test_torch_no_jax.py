"""The port runs where JAX is not installed, as on the GPU machine, and
imports nothing of the JAX package.

A subprocess whose ``sys.meta_path`` refuses ``jax``, ``jaxlib``,
``flax``, ``optax`` and the top-level ``second_tpu`` package (by exact
name, so ``second_tpu_torch`` still loads) imports the port and
``chip_smoke.py``, runs the small car.fhd slices on the CPU (random
weights: one inference frame, one training step at batch 2, each on
the host plan and again on the device route, which ships points and
builds the voxels and rulebooks on the device), one
request of the small PointPillars slice (the flat pillar path),
``train`` for one step at batch 2 on a 2-frame fixture tree (the
device voxelizer, checkpoint, the eval into the official AP) followed by
``evaluate``, then ``create_data.kitti_data_prep`` on another 2-frame
tree and one sampled car.fhd step through ``train`` (a car.fhd-shaped
config with its GT-database sampler, host rulebooks, rotated NMS in the
eval), one request of all.fhd (four classes) cut to a small width
with multi-class NMS, one request each of the small car.fhd and
PointPillars slices under mixed precision (bf16: K1-bf16's plain
version, the bf16 RPN), one request of the nuScenes multi-head
PointPillars cut to a small width (``test_torch_mhead.reduced_text``)
on a frame of a nuScenes-format fixture tree (``tools/nusc_fixture.py``;
the nuScenes dataset, the flat pillar path through both heads) and the
tree's GT database, and checks that none of the refused modules got
loaded. It also imports the fine-tuning tools (``script``, the
checkpoint import and its upstream fixture), the viewer backend, the
host utilities and the data-parallel package (``parallel``, its
``mesh`` and ``dryrun``).
"""

import json
import os
import subprocess
import sys

import numpy as np

from test_torch_fhd_train import _fhd_config
from test_torch_mhead import reduced_text as mhead_text
from test_torch_multiclass import frame_points, reduced_text
from test_torch_pointpillars import SMALL_PP_CONFIG, small_pp_points
from test_torch_slice import SMALL_FHD_CONFIG, small_fhd_points
from test_torch_train import CAR_BOXES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib.abc
import json
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "second_tpu")


class RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is refused in this process")
        return None


sys.meta_path.insert(0, RefuseJax())

import numpy as np

import chip_smoke  # noqa: F401  (the GPU smoke imports no JAX either)
from second_tpu_torch import create_data
from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.configs import loads_pipeline_config
from second_tpu_torch.core.inference import InferenceContext, example_to_device
from second_tpu_torch.data import merge_second_batch
from second_tpu_torch.models import middle, pp_fast, rpn, voxel_encoders  # noqa
from second_tpu_torch.ops import box_ops_torch, losses  # noqa: F401
from second_tpu_torch.ops import cuda_sparse_conv_bf16  # noqa: F401
from second_tpu_torch.ops import voxelize  # noqa: F401
from second_tpu_torch import parallel  # noqa: F401
from second_tpu_torch.parallel import dryrun, mesh  # noqa: F401
from second_tpu_torch.data import kitti_dataset, loader, prefetch  # noqa
from second_tpu_torch.data import nusc_eval, nuscenes_dataset  # noqa: F401
from second_tpu_torch.data.gt_database import create_groundtruth_database
from second_tpu_torch.models import multi_head  # noqa: F401
from second_tpu_torch.native import eval_native  # noqa: F401
from second_tpu_torch.tools import kitti_fixture, nusc_fixture  # noqa
from second_tpu_torch.tools import overfit_ap, proof_spread  # noqa: F401
from second_tpu_torch.train import checkpoint, optimizer  # noqa: F401
from second_tpu_torch.train.__main__ import evaluate, train
from second_tpu_torch.train.state import make_train_step, make_voxelizer_fn
from second_tpu_torch.utils import eval as kitti_eval  # noqa: F401
from second_tpu_torch.utils import fire_lite, log_tool, timer  # noqa: F401
# the fine-tuning tools, the viewer and the host utilities (import only)
from second_tpu_torch import script  # noqa: F401
from second_tpu_torch.core import nms_cpu  # noqa: F401
from second_tpu_torch.kittiviewer import backend  # noqa: F401
from second_tpu_torch.ops import array_ops  # noqa: F401
from second_tpu_torch.tools import upstream_fixture  # noqa: F401
from second_tpu_torch.utils import bbox_plot, checkpoint_import  # noqa
from second_tpu_torch.utils import loader as module_loader  # noqa: F401
from second_tpu_torch.utils import merge_result, model_tool  # noqa: F401
from second_tpu_torch.utils import progress_bar, simplevis  # noqa: F401

(config_path, points_path, boxes_path, pp_config_path, pp_points_path,
 work, fhd_config_path, all_config_path, all_points_path,
 mhead_config_path) = sys.argv[1:11]
with open(config_path) as f:
    cfg = loads_pipeline_config(f.read())
points, boxes = np.load(points_path), np.load(boxes_path)
ctx = InferenceContext()
ctx.build(cfg, device="cpu")
ctx.init_random(0)
dets = ctx.inference(ctx.get_inference_input_dict({}, points))

parts = ctx.parts
prep = build_prep_func(cfg.train_input_reader, parts, training=True)
names = np.array(["Car"] * len(boxes))
batch = merge_second_batch([
    prep(input_dict={"lidar": {"points": points.copy(), "annotations": {
        "boxes": boxes.copy(), "names": names}}}) for _ in range(2)])
opt, lr_fn, mom_fn = optimizer.build(
    cfg.train_config.optimizer, cfg.train_config.steps,
    list(parts["net"].parameters()))
step = make_train_step(parts["net"], parts["spec"], opt, lr_fn, mom_fn)
metrics = step(example_to_device(batch, "cpu"))

# the device route: points in, voxels and rulebooks built on the device
dev = InferenceContext()
dev.build(cfg, device="cpu", device_voxelize=True)
dev.init_random(0)
dev_dets = dev.inference(dev.get_inference_input_dict({}, points))
cap = cfg.train_input_reader.preprocess.max_number_of_voxels
dev_prep = build_prep_func(cfg.train_input_reader, dev.parts, training=True,
                           emit_points=32768, compact_targets=True)
dev_batch = merge_second_batch([
    dev_prep(input_dict={"lidar": {"points": points.copy(), "annotations": {
        "boxes": boxes.copy(), "names": names}}}) for _ in range(2)])
opt, lr_fn, mom_fn = optimizer.build(
    cfg.train_config.optimizer, cfg.train_config.steps,
    list(dev.parts["net"].parameters()))
dev_metrics = make_train_step(
    dev.parts["net"], dev.parts["spec"], opt, lr_fn, mom_fn,
    voxelizer=make_voxelizer_fn(dev.parts["voxel_generator"], cap))(
        example_to_device(dev_batch, "cpu"))

with open(pp_config_path) as f:
    pp_cfg = loads_pipeline_config(f.read())
pp = InferenceContext()
pp.build(pp_cfg, device="cpu")
pp.init_random(0)
pp_dets = pp.inference(
    pp.get_inference_input_dict({}, np.load(pp_points_path)))[0]
from pathlib import Path

root = Path(work) / "kitti"
ids = kitti_fixture.build_kitti_dir(root, num_frames=2, seed=0)
kitti_dataset.create_kitti_info_file(str(root), ids, ids)
for reader, split in ((pp_cfg.train_input_reader, "train"),
                      (pp_cfg.eval_input_reader, "val")):
    reader.dataset.dataset_class_name = "KittiDataset"
    reader.dataset.kitti_root_path = str(root)
    reader.dataset.kitti_info_path = str(root / f"kitti_infos_{split}.pkl")
    reader.batch_size = 2
    reader.preprocess.num_workers = 0
pp_cfg.train_config.steps = 1
(Path(work) / "pp.config").write_text(pp_cfg.to_text())
train(str(Path(work) / "pp.config"), str(Path(work) / "model"), device="cpu")
res = evaluate(str(Path(work) / "pp.config"), str(Path(work) / "model"),
               device="cpu")
fhd_root = Path(work) / "fhd_kitti"
ids = kitti_fixture.build_kitti_dir(
    fhd_root, num_frames=2, seed=0,
    scene_kwargs=dict(num_cars=4, x_range=(2.0, 20.48),
                      y_range=(-10.24, 10.24), min_gap=4.6))
sets = Path(work) / "sets"
sets.mkdir()
for split in ("train", "val"):
    (sets / f"{split}.txt").write_text("\n".join(map(str, ids)) + "\n")
create_data.kitti_data_prep(str(fhd_root), imageset_dir=str(sets))
train(fhd_config_path, str(Path(work) / "fhd_model"), device="cpu")
# all.fhd (four classes) at a small width, one NMS per class
all_ctx = InferenceContext()
with open(all_config_path) as f:
    all_ctx.build(loads_pipeline_config(f.read()), device="cpu")
all_ctx.init_random(0)
all_dets = all_ctx.inference(
    all_ctx.get_inference_input_dict({}, np.load(all_points_path)))[0]
# mixed precision (bf16) on both slices
bf16 = {}
for name, base in (("fhd", cfg), ("pp", pp_cfg)):
    mp = loads_pipeline_config(base.to_text())
    mp.train_config.enable_mixed_precision = True
    mctx = InferenceContext()
    mctx.build(mp, device="cpu")
    mctx.init_random(0)
    pts = points if name == "fhd" else np.load(pp_points_path)
    mdets = mctx.inference(mctx.get_inference_input_dict({}, pts))[0]
    bf16[name] = (str(mctx.parts["net"].compute_dtype),
                  bool(np.isfinite(mdets["box3d_lidar"]).all()))
# the nuScenes multi-head network on a fixture frame, and its GT database
nusc_root = Path(work) / "nusc"
info_path = nusc_fixture.build_nusc_dir(
    nusc_root, num_frames=1, sweeps=2, points_per_sweep=1500,
    points_per_object=30, half_range=9.0, max_radius=16.0)
sensor = nuscenes_dataset.NuScenesDataset(
    nusc_root, info_path).get_sensor_data(0)
mhead = InferenceContext()
with open(mhead_config_path) as f:
    mhead.build(loads_pipeline_config(f.read()), device="cpu")
mhead.init_random(0)
mhead_dets = mhead.inference(mhead.get_inference_input_dict(
    sensor["metadata"], sensor["lidar"]["points"]))[0]
create_groundtruth_database("NuScenesDataset", str(nusc_root),
                            str(info_path))
loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))
print(json.dumps({"loaded": loaded, "n_frames": len(dets),
                  "box_shape": list(dets[0]["box3d_lidar"].shape),
                  "finite": bool(np.isfinite(dets[0]["box3d_lidar"]).all()),
                  "loss": float(metrics["loss"]),
                  "device_route_frames": len(dev_dets),
                  "device_route_finite": bool(
                      np.isfinite(dev_dets[0]["box3d_lidar"]).all()),
                  "device_route_loss": float(dev_metrics["loss"]),
                  "device_route_counts": list(
                      dev_metrics["sparse_active_counts"].shape),
                  "global_step": step.state.global_step,
                  "pp_flat": pp.flat_pp,
                  "pp_box_shape": list(pp_dets["box3d_lidar"].shape),
                  "pp_finite": bool(np.isfinite(pp_dets["box3d_lidar"]).all()),
                  "official": "official" in res["results"],
                  "all_fhd_multiclass": all_ctx.parts["spec"].multiclass_nms,
                  "all_fhd_classes": all_ctx.parts["spec"].num_class,
                  "all_fhd_box_shape": list(all_dets["box3d_lidar"].shape),
                  "all_fhd_finite": bool(
                      np.isfinite(all_dets["box3d_lidar"]).all()),
                  "all_fhd_labels": sorted(
                      set(all_dets["label_preds"].tolist())),
                  "bf16": bf16,
                  "mhead_net": type(mhead.parts["net"]).__name__,
                  "mhead_flat": mhead.flat_pp,
                  "mhead_box_shape": list(mhead_dets["box3d_lidar"].shape),
                  "mhead_finite": bool(
                      np.isfinite(mhead_dets["box3d_lidar"]).all()),
                  "mhead_token": mhead_dets["metadata"]["token"]}))
"""


def _fhd_train_config(work):
    """The car.fhd-shaped config of ``test_torch_fhd_train`` with its
    sampler, reading the tree the subprocess prepares under ``work``:
    one step at batch 2."""
    root = work / "fhd_kitti"
    cfg = _fhd_config(root)
    for reader, split in ((cfg.train_input_reader, "train"),
                          (cfg.eval_input_reader, "val")):
        reader.dataset.dataset_class_name = "KittiDataset"
        reader.dataset.kitti_root_path = str(root)
        reader.dataset.kitti_info_path = str(
            root / f"kitti_infos_{split}.pkl")
        reader.batch_size = 2
        reader.preprocess.num_workers = 0
    cfg.train_config.steps = 1
    path = work / "fhd.config"
    path.write_text(cfg.to_text())
    return path


def test_slice_runs_without_jax(tmp_path):
    config_path = tmp_path / "small_fhd.config"
    config_path.write_text(SMALL_FHD_CONFIG)
    points_path = tmp_path / "points.npy"
    np.save(points_path, small_fhd_points())
    boxes_path = tmp_path / "boxes.npy"
    np.save(boxes_path, CAR_BOXES)
    pp_config_path = tmp_path / "small_pp.config"
    pp_config_path.write_text(SMALL_PP_CONFIG)
    pp_points_path = tmp_path / "pp_points.npy"
    np.save(pp_points_path, small_pp_points())
    all_config_path = tmp_path / "all_fhd.config"
    all_config_path.write_text(reduced_text(multiclass_nms=True))
    all_points_path = tmp_path / "all_points.npy"
    np.save(all_points_path, frame_points(0))
    mhead_config_path = tmp_path / "mhead.config"
    mhead_config_path.write_text(mhead_text())
    # one intra-op thread: the tier-1 run puts 6 workers on the cores,
    # and torch's own threads in this process then oversubscribe them
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(config_path), str(points_path),
         str(boxes_path), str(pp_config_path), str(pp_points_path),
         str(tmp_path), str(_fhd_train_config(tmp_path)),
         str(all_config_path), str(all_points_path),
         str(mhead_config_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["n_frames"] == 1
    assert result["box_shape"][1:] == [7] and result["finite"]
    assert np.isfinite(result["loss"]) and result["global_step"] == 1
    assert result["device_route_frames"] == 1
    assert result["device_route_finite"]
    assert np.isfinite(result["device_route_loss"])
    assert result["device_route_counts"] == [2, 3, 2]
    assert result["pp_flat"]
    assert result["pp_box_shape"][0] > 0 and result["pp_box_shape"][1:] == [7]
    assert result["pp_finite"]
    assert result["official"]
    assert result["all_fhd_multiclass"] and result["all_fhd_classes"] == 4
    assert result["all_fhd_box_shape"][1:] == [7]
    assert result["all_fhd_finite"]
    assert set(result["all_fhd_labels"]) <= {0, 1, 2, 3}
    assert result["bf16"] == {"fhd": ["torch.bfloat16", True],
                              "pp": ["torch.bfloat16", True]}
    assert result["mhead_net"] == "VoxelNetNuscenesMultiHead"
    assert result["mhead_flat"] and result["mhead_finite"]
    assert result["mhead_box_shape"][0] > 0
    assert result["mhead_box_shape"][1:] == [7]
    assert result["mhead_token"] == "sample0000"
    assert (tmp_path / "nusc" / "kitti_dbinfos_train.pkl").is_file()
    log = (tmp_path / "model" / "log.txt").read_text()
    assert "Evaluation official" in log
    assert (tmp_path / "model" / "voxelnet-1.ckpt").is_file()
    assert (tmp_path / "fhd_kitti" / "kitti_dbinfos_train.pkl").is_file()
    fhd_log = (tmp_path / "fhd_model" / "log.txt").read_text()
    assert "sparse_util_max" in (
        tmp_path / "fhd_model" / "log.json.lst").read_text()
    assert "Evaluation official" in fhd_log
    assert (tmp_path / "fhd_model" / "voxelnet-1.ckpt").is_file()
