"""A whole sweep run on the CPU at a small size, past the harness's look
for a card, with the timed path broken underneath: ``correct`` must come
out false for each fault a sweep cell can have (an answer altered or
dropped where it is produced, host arrays altered, the network's output
altered), and true for the sound path."""

import time

import pytest
import torch

from benchmark import common
from benchmark.kinds import sweep
from benchmark.tests.small import small_config
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.models.voxelnet import VoxelNet


def _run(name, tmp_path):
    cfg = small_config(name, tmp_path)
    mix = dict(common.load_mix("sweep"), pool=3, warmup=1, sample=2)
    return sweep.run({
        "config": cfg, "mix": mix, "seed": 2 ** 31 + 11, "seconds": 1.0,
        "trace": False, "limits": common.load_limits(f"{name}.sweep"),
        "tmp": tmp_path, "t_process": time.perf_counter(),
        "device": torch.device("cpu")})


def _alter_answer(monkeypatch):
    inner = InferenceContext.inference

    def inference(self, example):
        out = inner(self, example)
        boxes = out[0]["box3d_lidar"].copy()
        boxes[:1, 0] += 0.5
        out[0]["box3d_lidar"] = boxes
        return out

    monkeypatch.setattr(InferenceContext, "inference", inference)


def _drop_answer(monkeypatch):
    inner = InferenceContext.inference

    def inference(self, example):
        out = inner(self, example)
        for k in ("box3d_lidar", "scores", "label_preds"):
            out[0][k] = out[0][k][1:]
        return out

    monkeypatch.setattr(InferenceContext, "inference", inference)


def _alter_host_arrays(monkeypatch):
    inner = InferenceContext.get_inference_input_dict

    def get(self, info, points):
        ex = inner(self, info, points)
        key = "points" if "points" in ex else "voxels"
        ex[key] = ex[key].copy()
        ex[key][0, 0] = 0.0
        return ex

    monkeypatch.setattr(InferenceContext, "get_inference_input_dict", get)


def _alter_network(monkeypatch):
    inner = VoxelNet.rpn_preds

    def rpn_preds(self, spatial):
        out = inner(self, spatial)
        out["cls_preds"] = out["cls_preds"] * 1.01
        return out

    monkeypatch.setattr(VoxelNet, "rpn_preds", rpn_preds)


FAULTS = {
    "answer_altered": (_alter_answer, "det_err"),
    "answer_dropped": (_drop_answer, "nms_violations"),
    "host_arrays_altered": (_alter_host_arrays, "prep_mismatch"),
    "network_altered": (_alter_network, "preds_err"),
}


@pytest.mark.parametrize("name", ["car_fhd", "pointpillars"])
def test_sound_run_is_correct(name, tmp_path):
    rec = _run(name, tmp_path)
    assert rec["correct"], rec["numbers"]
    assert rec["compared"] > 0 and rec["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["car_fhd", "pointpillars"])
def test_fault_is_caught(name, fault, tmp_path, monkeypatch):
    patch, number = FAULTS[fault]
    patch(monkeypatch)
    rec = _run(name, tmp_path)
    limits = common.load_limits(f"{name}.sweep")
    assert not rec["correct"]
    assert rec["numbers"][number] > limits[number], rec["numbers"]
