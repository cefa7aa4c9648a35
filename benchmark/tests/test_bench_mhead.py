"""The nuScenes multi-head cell's pieces on the CPU at a small size: its
driver past the harness's look for a card, with the timed path broken
underneath (``correct`` must come out false for each fault, true for the
sound path), its generator's sizes and time lags, its operation count
and the heads' bound against a hand count and PyTorch's own count, and
its metric readers on a program without the ``net.heads`` span."""

import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, flops, mhead_flops
from benchmark.gen import nusc_scenes
from benchmark.kinds import nusc_sweep
from benchmark.reference import multihead, nets
from benchmark.tests.small_mhead import small_mhead_config
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.models.multi_head import VoxelNetNuscenesMultiHead

CELL = "nusc_mhead.sweep"
# the large head's anchors on the small config's [25, 25]
LARGE = 10 * 25 * 25


def _run(tmp_path, trace=False):
    cfg = small_mhead_config(tmp_path)
    mix = dict(common.load_mix("nusc_sweep"), pool=3, warmup=1, sample=2,
               points_per_sweep=[3000, 3472])
    return nusc_sweep.run({
        "config": cfg, "mix": mix, "seed": 2 ** 31 + 13, "seconds": 1.0,
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


def _alter_answer(out):
    boxes = out["box3d_lidar"].copy()
    boxes[:1, 0] += 0.5
    out["box3d_lidar"] = boxes


def _drop_answer(out):
    for k in ("box3d_lidar", "scores", "label_preds"):
        out[k] = out[k][1:]


def _shift_labels(out):
    out["label_preds"] = (out["label_preds"] + 1) % 10


def _alter_host_arrays(monkeypatch):
    inner = InferenceContext.get_inference_input_dict

    def get(self, info, points):
        ex = inner(self, info, points)
        ex["points"] = ex["points"].copy()
        ex["points"][0, 0] = 0.0
        return ex

    monkeypatch.setattr(InferenceContext, "get_inference_input_dict", get)


def _patch_preds(monkeypatch, alter):
    inner = VoxelNetNuscenesMultiHead.rpn_preds

    def rpn_preds(self, spatial):
        return alter(inner(self, spatial))

    monkeypatch.setattr(VoxelNetNuscenesMultiHead, "rpn_preds", rpn_preds)


def _scale_logits(out):
    out["cls_preds"] = out["cls_preds"] * 1.01
    return out


def _swap_heads(out):
    return {k: torch.cat([v[:, LARGE:], v[:, :LARGE]], 1)
            for k, v in out.items()}


FAULTS = {
    "answer_altered": (lambda mp: _patch_inference(mp, _alter_answer),
                       "det_err"),
    "answer_dropped": (lambda mp: _patch_inference(mp, _drop_answer),
                       "nms_violations"),
    "labels_shifted": (lambda mp: _patch_inference(mp, _shift_labels),
                       "nms_violations"),
    "host_arrays_altered": (_alter_host_arrays, "prep_mismatch"),
    "network_altered": (lambda mp: _patch_preds(mp, _scale_logits),
                        "preds_err"),
    "heads_swapped": (lambda mp: _patch_preds(mp, _swap_heads),
                      "preds_err"),
}


def test_sound_run_is_correct(tmp_path):
    rec = _run(tmp_path, trace=True)
    assert rec["correct"], rec["numbers"]
    assert rec["compared"] > 0 and rec["failed"] == 0
    assert len(rec["ops"]) > 0 and min(rec["ops"]) > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, tmp_path, monkeypatch):
    patch, number = FAULTS[fault]
    patch(monkeypatch)
    rec = _run(tmp_path)
    limits = common.load_limits(CELL)
    assert not rec["correct"]
    assert rec["numbers"][number] > limits[number], rec["numbers"]


def test_pool_is_the_same_work_for_every_seed():
    mix = common.load_mix("nusc_sweep")
    sizes = nusc_scenes.pool_sizes(mix)
    assert len(sizes) == mix["pool"] == 32
    assert sizes[0] == (30000, 1) and sizes[-1] == (34720, 2)
    assert sorted({o for _, o in sizes}) == [1, 2, 3, 4, 5]
    small = dict(mix, pool=4, points_per_sweep=[3000, 3472])
    shapes = []
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        pool = nusc_scenes.frame_pool(seed, small)
        shapes.append(sorted(len(p) for p in pool))
        for pts in pool:
            assert pts.dtype == np.float32 and pts.shape[1] == 4
            lags = np.unique(pts[:, 3])
            assert len(lags) == 10
            assert lags[0] == 0 and np.isclose(lags[-1], 0.45)
            # the key frame's points first, then each earlier sweep's
            assert np.all(np.diff(pts[:, 3]) >= 0)
    assert shapes[0] == shapes[1] == [30000, 31570, 33150, 34720]
    a = nusc_scenes.frame_pool(2 ** 31 + 1, small)[0]
    b = nusc_scenes.frame_pool(2 ** 31 + 1, small)[0]
    assert np.array_equal(a, b)


def test_operation_count_and_heads_bound_by_hand(tmp_path):
    """On the small config (a 100 x 100 canvas of 64 channels)."""
    m = small_mhead_config(tmp_path)["model"]
    conv = lambda h, w, ci, co, k: 2 * h * w * ci * co * k * k  # noqa: E731
    backbone = (conv(100, 100, 64, 64, 3) * 4 + conv(25, 25, 64, 128, 4)
                + conv(50, 50, 64, 128, 3) + 5 * conv(50, 50, 128, 128, 3)
                + conv(25, 25, 128, 128, 2)
                + conv(25, 25, 128, 256, 3) + 5 * conv(25, 25, 256, 256, 3)
                + conv(25, 25, 256, 128, 1))
    out = 10 * (7 + 10 + 2)
    heads = (3 * conv(80, 80, 64, 64, 3) + conv(80, 80, 64, out, 1)
             + conv(25, 25, 384, out, 1))
    assert mhead_flops.backbone_ops(m) == backbone
    assert mhead_flops.heads_ops(m) == heads
    counts = np.array([3, 20, 7])
    assert mhead_flops.request_ops(m, counts) == (
        2 * 30 * 8 * 64 + backbone + heads)
    nbytes = 4 * (64 * 80 * 80 + 384 * 25 * 25
                  + 3 * 64 * 64 * 9 + 3 * 4 * 64
                  + 65 * out + 385 * out + (80 * 80 + 25 * 25) * out)
    assert mhead_flops.heads_bytes(m) == nbytes
    assert mhead_flops.heads_bound_s(m) == max(
        heads / flops.PEAK_FLOPS, nbytes / flops.PEAK_HBM_BYTES)


def test_operation_count_matches_pytorchs(tmp_path):
    """PyTorch's count of the reference's convolutions, on random
    weights: the backbone, then the heads."""
    cfg = small_mhead_config(tmp_path)
    m = cfg["model"]
    ctx = InferenceContext()
    ctx.build(cfg["repo_config"], "cpu")
    g = torch.Generator().manual_seed(0)
    w = {k: torch.randn(v.shape, generator=g) * 0.1
         for k, v in ctx.parts["net"].state_dict().items()}
    for k in w:
        if k.endswith("running_var"):
            w[k] = w[k].abs() + 1.0
    canvas = torch.randn(1, 64, 100, 100, generator=g)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        stage0, out = multihead.backbone(w, m, canvas, nets.eval_bn)
    assert fc.get_total_flops() == mhead_flops.backbone_ops(m)
    maps = {"large_head": out, "small_head": stage0[:, :, 10:-10, 10:-10]}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        for h in multihead.HEADS:
            x = multihead.head_input(w, m, h, maps[h], nets.eval_bn)
            multihead.head_preds(w, m, h, x)
    assert fc.get_total_flops() == mhead_flops.heads_ops(m)


@pytest.mark.parametrize("name", ["heads_gpu_ms.sweep",
                                  "heads_roofline.sweep"])
def test_heads_readers(name):
    """Nothing to read where the program has no ``net.heads`` span (the
    record then lacks its time); a share of the bound otherwise."""
    read = common.load_reader(name)
    assert read({"trace": {"busy_s": 1.0, "window_s": 2.0}}) is None
    got = read({"heads_gpu_s": 2e-3, "heads_bound_s": 1.6e-4})
    assert got == pytest.approx(2.0 if name.startswith("heads_gpu")
                                else 8.0)
