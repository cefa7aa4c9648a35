"""The port runs where JAX is not installed, as on the GPU machine, and
imports nothing of the JAX package.

A subprocess whose ``sys.meta_path`` refuses ``jax``, ``jaxlib``,
``flax``, ``optax`` and the top-level ``second_tpu`` package (by exact
name, so ``second_tpu_torch`` still loads) imports the port and
``chip_smoke.py``, runs the small car.fhd slices on the CPU (random
weights: one inference frame, one training step at batch 2) and one
request of the small PointPillars slice (the flat pillar path), and
checks that none of the refused modules got loaded.
"""

import json
import os
import subprocess
import sys

import numpy as np

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
from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.configs import loads_pipeline_config
from second_tpu_torch.core.inference import InferenceContext, example_to_device
from second_tpu_torch.data import merge_second_batch
from second_tpu_torch.models import middle, pp_fast, voxel_encoders  # noqa
from second_tpu_torch.ops import voxelize  # noqa: F401
from second_tpu_torch.train import optimizer
from second_tpu_torch.train.state import make_train_step

config_path, points_path, boxes_path, pp_config_path, pp_points_path = (
    sys.argv[1:6])
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

with open(pp_config_path) as f:
    pp_cfg = loads_pipeline_config(f.read())
pp = InferenceContext()
pp.build(pp_cfg, device="cpu")
pp.init_random(0)
pp_dets = pp.inference(
    pp.get_inference_input_dict({}, np.load(pp_points_path)))[0]
loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))
print(json.dumps({"loaded": loaded, "n_frames": len(dets),
                  "box_shape": list(dets[0]["box3d_lidar"].shape),
                  "finite": bool(np.isfinite(dets[0]["box3d_lidar"]).all()),
                  "loss": float(metrics["loss"]),
                  "global_step": step.state.global_step,
                  "pp_flat": pp.flat_pp,
                  "pp_box_shape": list(pp_dets["box3d_lidar"].shape),
                  "pp_finite": bool(np.isfinite(pp_dets["box3d_lidar"]).all())}))
"""


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
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(config_path), str(points_path),
         str(boxes_path), str(pp_config_path), str(pp_points_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["n_frames"] == 1
    assert result["box_shape"][1:] == [7] and result["finite"]
    assert np.isfinite(result["loss"]) and result["global_step"] == 1
    assert result["pp_flat"]
    assert result["pp_box_shape"][0] > 0 and result["pp_box_shape"][1:] == [7]
    assert result["pp_finite"]
