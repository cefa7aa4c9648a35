"""The port's nuScenes multi-head PointPillars (``VoxelNetNuscenesMultiHead``
on ``RPNNoHead``) against the benchmark's plain reference
(``benchmark/reference/multihead.py``: plain PyTorch and NumPy, nothing
of the port) on seeded random weights, on the CPU.

The configuration is the benchmark's ``nusc_mhead`` at its published
widths (PFN 64, RPN 3 + 5 + 5 layers of 64, 128 and 256, deblocks 128 x
3, the small head's 64) on a +-12.5 m patch: a 100 x 100 pillar grid,
the large classes' anchors on [1, 25, 25], the small classes' on the
cropped stage0's [1, 80, 80] (``benchmark/tests/small_mhead.py``). The
weights are the benchmark's (``benchmark/mhead_weights.py``), calibrated
on a frame of the seed. Tolerances: each head's preds within 1e-4 of
their largest magnitude (fp32 sums in another order, as
``benchmark/tests/test_bench_reference.py`` holds the single-head
networks), anchors and host arrays exact, the detections through the
reference's judge with the labels checked (``multihead.judge``, the
cell's tolerances) with no violation.
"""

import numpy as np
import pytest
import torch

from benchmark import common, mhead_weights
from benchmark.reference import judge, multihead
from benchmark.tests.small_mhead import small_frame, small_mhead_config
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.models.multi_head import VoxelNetNuscenesMultiHead

CPU = torch.device("cpu")
PREDS_TOL = 1e-4
DET_TOL = 1e-3
SEED = 2 ** 31 + 19
# the large head's anchors (5 classes x 2 rotations on [25, 25]) come
# first, then the small head's (on [80, 80])
LARGE = 10 * 25 * 25


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = small_mhead_config(tmp_path_factory.mktemp("mhead"))
    ctx = InferenceContext()
    ctx.build(cfg["repo_config"], CPU)
    net = ctx.parts["net"]
    net.eval()
    calib = small_frame(cfg, np.random.default_rng([SEED, 2]))
    w = mhead_weights.make(net, cfg, SEED, calib, CPU)
    net.load_state_dict(w, strict=True)
    points = small_frame(cfg, np.random.default_rng([SEED, 1]))
    ref = multihead.request(cfg["model"], w, points, CPU, 100)
    return {"cfg": cfg, "ctx": ctx, "w": w, "points": points, "ref": ref}


def _port_preds(s, path):
    """The port's preds [A, ...] on ``path``: the flat pillar path that
    requests take, or the module path (the pillar encoder and the
    scatter) on the reference's pillars."""
    ctx = s["ctx"]
    if path == "flat":
        ex = ctx.get_inference_input_dict({"token": "t"}, s["points"])
        preds = ctx._run(ex)[0]
    else:
        vox, counts, coords = s["ref"]["net_in"]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None]
        with torch.no_grad():
            preds = ctx.parts["net"](t(vox), t(counts), t(coords))
    return {k: v[0] for k, v in preds.items()}


def test_anchors_and_their_order(setup):
    model = setup["cfg"]["model"]
    ctx = setup["ctx"]
    anc = multihead.anchors(model)
    assert np.array_equal(anc, ctx.parts["anchor_cache"]["anchors"])
    assert len(anc) == LARGE + 10 * 80 * 80
    ta = ctx.parts["target_assigner"]
    start = 0
    for c in model["classes"]:
        nz, ny, nx = c["feature_map_size"]
        n = 2 * ny * nx
        assert ta.anchors_range(c["name"]) == (start, start + n)
        block = anc[start:start + n].reshape(2, ny, nx, 7)
        # rotations slowest, then y, then x; the class's size throughout
        assert np.all(block[0, ..., 6] == 0) and np.allclose(
            block[1, ..., 6], 1.57)
        assert np.all(np.diff(block[0, 0, :, 0]) > 0)
        assert np.all(np.diff(block[0, :, 0, 1]) > 0)
        assert np.allclose(block[..., 3:6], c["sizes"])
        start += n


def test_host_arrays_equal_the_port(setup):
    ex = setup["ctx"].get_inference_input_dict({"token": "t"},
                                               setup["points"])
    assert judge.prep_mismatch(ex, setup["ref"]["ex"]) == 0


@pytest.mark.parametrize("head", ["large", "small"])
@pytest.mark.parametrize("path", ["module", "flat"])
def test_head_preds_follow_the_reference(setup, path, head):
    got, ref = _port_preds(setup, path), setup["ref"]["preds"]
    part = slice(0, LARGE) if head == "large" else slice(LARGE, None)
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        assert got[key].shape == ref[key].shape, key
        err = judge.preds_err({key: got[key][part]}, {key: ref[key][part]})
        assert err <= PREDS_TOL, (key, err)


def test_detections_and_labels_pass_the_judge(setup):
    model = setup["cfg"]["model"]
    tol = common.load_mix("nusc_sweep")["tolerance"]
    ctx = setup["ctx"]
    out = ctx.inference(ctx.get_inference_input_dict({"token": "t"},
                                                     setup["points"]))[0]
    labels = out["label_preds"]
    assert len(labels) > 0 and len(set(labels.tolist())) > 1
    d_err, bad, why = multihead.judge(model, out["box3d_lidar"],
                                      out["scores"], labels,
                                      setup["ref"]["cand"], tol)
    assert bad == 0, why
    assert d_err <= DET_TOL


def _heads_swapped(monkeypatch):
    inner = VoxelNetNuscenesMultiHead.rpn_preds

    def rpn_preds(self, spatial):
        out = inner(self, spatial)
        return {k: torch.cat([v[:, LARGE:], v[:, :LARGE]], 1)
                for k, v in out.items()}

    monkeypatch.setattr(VoxelNetNuscenesMultiHead, "rpn_preds", rpn_preds)


def _labels_shifted(monkeypatch):
    inner = InferenceContext.inference

    def inference(self, example):
        out = inner(self, example)
        out[0]["label_preds"] = (out[0]["label_preds"] + 1) % 10
        return out

    monkeypatch.setattr(InferenceContext, "inference", inference)


@pytest.mark.parametrize("fault", ["heads_swapped", "labels_shifted"])
def test_planted_fault_is_caught(setup, fault, monkeypatch):
    """The judge and the preds' comparison catch a small head
    concatenated before the large one, and labels shifted by one."""
    {"heads_swapped": _heads_swapped,
     "labels_shifted": _labels_shifted}[fault](monkeypatch)
    model = setup["cfg"]["model"]
    tol = common.load_mix("nusc_sweep")["tolerance"]
    ctx = setup["ctx"]
    ex = ctx.get_inference_input_dict({"token": "t"}, setup["points"])
    out = ctx.inference(ex)[0]
    _, bad, why = multihead.judge(model, out["box3d_lidar"], out["scores"],
                                  out["label_preds"], setup["ref"]["cand"],
                                  tol)
    assert bad > 0, why
    if fault == "heads_swapped":
        got = {k: v[0] for k, v in ctx._run(ex)[0].items()}
        assert judge.preds_err(got, setup["ref"]["preds"]) > PREDS_TOL
    else:
        assert why["label"] > 0
