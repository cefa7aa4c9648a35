"""The nuScenes residual sparse cell's pieces on the CPU at a small size
(``small_res8x.py``, its pool drawn by ``small_res8x_frame``): its kind
(``kinds/nusc_voxel_sweep.py``) past the harness's look for a card, with
the timed path broken underneath (``correct`` must come out false for
each fault, true for the sound path), the middle's overflow judged, its
operation count against a hand count, and its metric readers on a
program without the ``net.middle.wide`` span or the 128-wide K1."""

import time

import numpy as np
import pytest
import torch

from benchmark import common, res8x_flops
from benchmark.kinds import nusc_voxel_sweep
from benchmark.reference import res8x
from benchmark.tests.small_res8x import small_res8x_config, small_res8x_frame
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.models import sparse_middle, sparse_resnet

CELL = "nusc_res8x.sweep"


def _small_pool(monkeypatch):
    """The kind's frames drawn for the small patch."""
    gen = nusc_voxel_sweep.nusc_scenes
    monkeypatch.setattr(gen, "frame_pool", lambda seed, mix: [
        small_res8x_frame(np.random.default_rng([seed, 1, i]))
        for i in range(mix["pool"])])


def _run(tmp_path, monkeypatch, trace=False):
    _small_pool(monkeypatch)
    cfg = small_res8x_config(tmp_path)
    mix = dict(common.load_mix("nusc_voxel_sweep"), pool=3, warmup=1,
               sample=2)
    return nusc_voxel_sweep.run({
        "config": cfg, "mix": mix, "seed": 2 ** 31 + 17, "seconds": 1.0,
        "trace": trace, "limits": common.load_limits(CELL),
        "tmp": tmp_path, "t_process": time.perf_counter(),
        "device": torch.device("cpu")})


def _patch_inference(monkeypatch, alter):
    inner = InferenceContext.inference

    def inference(self, example):
        out = inner(self, example)
        alter(out[0])
        return out

    monkeypatch.setattr(InferenceContext, "inference", inference)


def _shift_labels(out):
    out["label_preds"] = (out["label_preds"] + 1) % 10


def _alter_answer(out):
    boxes = out["box3d_lidar"].copy()
    boxes[:1, 0] += 0.5
    out["box3d_lidar"] = boxes


def _alter_voxels(monkeypatch):
    inner = InferenceContext.get_inference_input_dict

    def get(self, info, points):
        ex = inner(self, info, points)
        ex["voxels"] = ex["voxels"].copy()
        ex["voxels"][0, 0, 0, 0] += 1.0
        return ex

    monkeypatch.setattr(InferenceContext, "get_inference_input_dict", get)


def _no_residual(monkeypatch):
    """Every block drops its identity: the residual path, broken."""
    def forward(self, grid, slots):
        out = sparse_resnet.sparse.subm_conv(grid, slots, self.conv1_w)
        out = out._replace(features=torch.relu(
            self.bn1(out.features, mask=grid.valid)))
        out = sparse_resnet.sparse.subm_conv(out, slots, self.conv2_w)
        return sparse_resnet._masked(out, torch.relu(
            self.bn2(out.features, mask=grid.valid)))

    monkeypatch.setattr(sparse_resnet.SparseBasicBlock, "forward", forward)


def _small_capacity(monkeypatch):
    monkeypatch.setattr(sparse_middle.SpMiddleResNetFHD, "capacity_factors",
                        (0.5, 0.5, 0.5, 0.5))


FAULTS = {
    "labels_shifted": (lambda mp: _patch_inference(mp, _shift_labels),
                       "nms_violations"),
    "answer_altered": (lambda mp: _patch_inference(mp, _alter_answer),
                       "det_err"),
    "voxels_altered": (_alter_voxels, "prep_mismatch"),
    "residual_dropped": (_no_residual, "preds_err"),
    "capacity_cut": (_small_capacity, "sparse_rows_overflow"),
}


def test_sound_run_is_correct(tmp_path, monkeypatch):
    rec = _run(tmp_path, monkeypatch, trace=True)
    assert rec["correct"], rec["numbers"]
    assert rec["compared"] > 0 and rec["failed"] == 0
    assert rec["numbers"]["sparse_rows_overflow"] == 0
    assert len(rec["ops"]) > 0 and min(rec["ops"]) > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, tmp_path, monkeypatch):
    patch, number = FAULTS[fault]
    patch(monkeypatch)
    rec = _run(tmp_path, monkeypatch)
    limits = common.load_limits(CELL)
    assert not rec["correct"]
    assert rec["numbers"][number] > limits[number], rec["numbers"]


def test_operation_count_by_hand(tmp_path):
    """The middle's operations are 2 x hits x Cin x Cout of its 21 sparse
    convs (a block counts two), the wide ones those with Cout 128."""
    model = small_res8x_config(tmp_path)["model"]
    _, (_, _, coords) = res8x.host_example(
        model, small_res8x_frame(np.random.default_rng(3)))
    scales, _ = res8x.plan(model, coords, torch.device("cpu"))
    convs = res8x.work(model, scales)
    assert len(convs) == 21
    assert [c["cout"] for c in convs].count(128) == 6
    hits = [int((s["subm"] < len(s["lin"])).sum()) for s in scales[:4]]
    assert [c["pairs"] for c in convs if c["k"] == 27 and c["vin"] ==
            c["vout"]] == [hits[0]] * 5 + [hits[1]] * 4 + [hits[2]] * 4 + [
                hits[3]] * 4
    ops, k1, wide = res8x_flops.request_work(model, scales)
    middle = sum(2 * c["pairs"] * c["cin"] * c["cout"] for c in convs)
    _, d, h, w = scales[-1]["shape"]
    assert ops == middle + res8x_flops.neck_ops(model, 128 * d, h, w)
    assert 0 < wide < k1


@pytest.mark.parametrize("name", ["wide_gpu_ms.sweep", "wide_roofline.sweep"])
def test_wide_readers_read_nothing_without_the_stage(name):
    """A program without the span or the 128-wide K1 (the parent's):
    nothing to read, no error."""
    read = common.load_reader(name)
    assert read({}) is None
    trace = {"kernels": {"void sparse_conv_kernel<64, 64>(float const*)":
                         1e-3}, "busy_s": 1.0, "window_s": 2.0}
    assert read({"trace": trace, "wide_bound_s": 1e-4}) is None


def test_wide_roofline_reads_the_128_wide_launches():
    read = common.load_reader("wide_roofline.sweep")
    trace = {"kernels": {
        "void (anonymous namespace)::sparse_conv_kernel<64, 128>(float const*)":
            1e-3,
        "void (anonymous namespace)::sparse_conv_kernel<128, 128>(float const*)":
            3e-3,
        "void (anonymous namespace)::sparse_conv_kernel<64, 64>(float const*)":
            5e-3}}
    assert read({"trace": trace, "wide_bound_s": 2e-4}) == pytest.approx(5.0)
