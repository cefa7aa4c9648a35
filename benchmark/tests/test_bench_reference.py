"""The plain reference and the counters held to the port on the CPU at a
small size (and, for the host arrays and anchors, at the published
one): the same host arrays exactly, the same preds to fp32 rounding,
detections that pass the judge, and operation counts that match
PyTorch's own count of the port's convolutions."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, flops, weights
from benchmark.gen import scenes
from benchmark.reference import boxes, judge, pipeline
from benchmark.tests.small import small_config
from second_tpu_torch.builders.network_builder import build_network
from second_tpu_torch.configs import load_pipeline_config
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.ops import cuda_iou

CPU = torch.device("cpu")
# fp32 sums in another order (gather-GEMM and convolutions on the CPU):
# the preds' widest gap over their largest magnitude
PREDS_TOL = 1e-4
DET_TOL = 1e-3


def _ctx(cfg):
    ctx = InferenceContext()
    ctx.build(str(common.ROOT / cfg["repo_config"]), CPU)
    ctx.parts["net"].eval()
    return ctx


@pytest.mark.parametrize("name", ["car_fhd", "pointpillars"])
def test_config_file_matches_the_port(name):
    """The benchmark's copy of the sizes is the port's parsed config."""
    cfg = common.load_config(name)
    m = cfg["model"]
    pipe = load_pipeline_config(str(common.ROOT / cfg["repo_config"]))
    parts = build_network(pipe, CPU)
    gen = parts["voxel_generator"]
    assert np.allclose(gen.point_cloud_range, m["point_cloud_range"])
    assert np.allclose(gen.voxel_size, m["voxel_size"])
    assert list(gen.grid_size[::-1]) == m["grid_zyx"]
    assert gen.max_num_points_per_voxel == m["max_points_per_voxel"]
    assert pipe.eval_input_reader.preprocess.max_number_of_voxels == (
        m["max_voxels"])
    spec = parts["spec"]
    assert spec.nms_pre_max_sizes[0] == m["nms"]["pre_max"]
    assert spec.nms_post_max_sizes[0] == m["nms"]["post_max"]
    assert np.isclose(spec.nms_score_thresholds[0],
                      m["nms"]["score_threshold"])
    assert np.isclose(spec.nms_iou_thresholds[0], m["nms"]["iou_threshold"])
    assert spec.use_rotate_nms == m["nms"]["rotated"]
    assert np.allclose(spec.post_center_range, m["post_center_range"])
    assert spec.dir_limit_offset == m["dir"]["limit_offset"]
    # the reference's anchors are the port's, bit for bit
    assert np.array_equal(boxes.anchors(m), parts["anchor_cache"]["anchors"])
    params = sum(v.numel() for k, v in parts["net"].state_dict().items()
                 if "running" not in k)
    assert params == {"car_fhd": 5360468, "pointpillars": 4814804}[name]


@pytest.mark.parametrize("name", ["car_fhd", "pointpillars"])
def test_host_arrays_equal_the_port(name):
    """At the published size: voxels (or padded points and the anchor
    mask) exactly the port's host preparation's."""
    cfg = common.load_config(name)
    mix = common.load_mix("sweep")
    ctx = _ctx(cfg)
    for pts in scenes.sweep_pool(2 ** 31 + 99, dict(mix, pool=2)):
        ex = ctx.get_inference_input_dict({}, pts)
        ref, _ = pipeline.host_example(cfg["model"], pts)
        assert judge.prep_mismatch(ex, ref) == 0


@pytest.mark.parametrize("name", ["car_fhd", "pointpillars"])
def test_reference_follows_the_port(name, tmp_path):
    cfg = small_config(name, tmp_path)
    model, mix = cfg["model"], common.load_mix("sweep")
    ctx = _ctx(cfg)
    net = ctx.parts["net"]
    pool = scenes.sweep_pool(7, dict(mix, pool=2))
    w = weights.make(net, cfg, 7, pool[0], CPU)
    net.load_state_dict(w, strict=True)
    for pts in pool:
        ex = ctx.get_inference_input_dict({}, pts)
        preds, _ = ctx.run(ex)
        out = ctx.inference(ex)[0]
        ref = pipeline.request(model, w, pts, CPU, mix["candidate_margin"])
        assert judge.prep_mismatch(ex, ref["ex"]) == 0
        assert judge.preds_err({k: v[0] for k, v in preds.items()},
                               ref["preds"]) < PREDS_TOL
        d, bad, why = judge.judge(model, out["box3d_lidar"], out["scores"],
                                  ref["cand"], mix["tolerance"])
        assert d < DET_TOL and bad == 0, why
        assert len(out["scores"]) > 0
        # the reference's own NMS passes its judge
        b, s = boxes.detections(model, ref["cand"])
        assert judge.judge(model, b, s, ref["cand"], mix["tolerance"])[1] == 0


@pytest.mark.parametrize("flipped,accepted", [(0, True), (1, False)])
def test_direction_ties_go_either_way(flipped, accepted):
    """A detection whose yaw is a half turn from its candidate's passes
    only where that candidate's two direction logits tie within dir_eps."""
    model = common.load_config("pointpillars")["model"]
    tol = common.load_mix("sweep")["tolerance"]
    b = np.array([[10.0, 0.0, -1.0, 1.6, 3.9, 1.5, 0.3],
                  [30.0, 20.0, -1.0, 1.6, 3.9, 1.5, -1.0]])
    cand = {"boxes": b, "bev": b[:, [0, 1, 3, 4, 6]],
            "scores": np.array([0.9, 0.8]), "in_range": np.ones(2, bool),
            "top": np.ones(2, bool),
            "dir_margin": np.array([tol["dir_eps"] / 10, 0.5])}
    dets = b.copy()
    dets[flipped, 6] += np.pi
    d, bad, why = judge.judge(model, dets, cand["scores"], cand, tol)
    assert (bad == 0 and d < 1e-9) == accepted, (d, why)


def test_rotated_iou_equals_the_ports_plain_version():
    rng = np.random.default_rng(0)
    n = 300
    b = np.stack([rng.uniform(0, 10, n), rng.uniform(0, 10, n),
                  rng.uniform(0.5, 3, n), rng.uniform(1, 6, n),
                  rng.uniform(-3.2, 3.2, n)], 1)
    i, j, iou = boxes.overlaps(b, True)
    full = cuda_iou.rotated_iou_matrix_plain(
        torch.tensor(b), torch.tensor(b)).numpy()
    assert np.abs(full[i, j] - iou).max() < 1e-9
    # pairs left out never overlap
    out = np.ones_like(full, bool)
    out[i, j] = False
    np.fill_diagonal(out, False)
    assert np.all(np.triu(full, 1)[np.triu(out, 1)] == 0)


@pytest.mark.parametrize("name", ["car_fhd", "pointpillars"])
def test_operation_counts(name, tmp_path):
    """The RPN's count equals PyTorch's count of the port's RPN; the
    middle's rulebook hits equal the port's host planner's."""
    cfg = small_config(name, tmp_path)
    model = cfg["model"]
    ctx = _ctx(cfg)
    net = ctx.parts["net"]
    _, ny, nx = model["grid_zyx"]
    if model["network"] == "second":
        c = model["middle_topology"][-1][1] * 2
        h, w = ny // model["feature_stride"], nx // model["feature_stride"]
    else:
        c, h, w = model["pfn_filters"], ny, nx
    with FlopCounterMode(display=False) as fc:
        net.rpn(torch.zeros(1, c, h, w))
    assert flops.rpn_flops(model, c, h, w) == fc.get_total_flops()
    if model["network"] != "second":
        return
    pts = scenes.sweep_pool(3, dict(common.load_mix("sweep"), pool=1))[0]
    ex = ctx.get_inference_input_dict({}, pts)
    _, (vox, counts, coords) = pipeline.host_example(model, pts)
    work, _ = flops.middle_work(model, coords, CPU)
    v = int((ex["coordinates"][0][:, 0] >= 0).sum())
    rows = {"plan_subm0": v}
    for i in range(3):
        rows[f"plan_conv{i}"] = rows[f"plan_subm{i}"]
        if i < 2:
            rows[f"plan_subm{i + 1}"] = int(
                (ex[f"plan_coords{i}"][0][:, 0] >= 0).sum())
    plans = ["plan_subm0", "plan_subm0", "plan_conv0", "plan_subm1",
             "plan_subm1", "plan_conv1", "plan_subm2", "plan_subm2",
             "plan_subm2", "plan_conv2"]
    for cw, plan in zip(work, plans):
        slots = ex[plan][0]
        hits = int(((slots >= 0) & (slots < _in_cap(ex, plan))).sum())
        assert cw["pairs"] == hits, plan
        assert cw["vin"] == rows[plan]


def _in_cap(ex, plan):
    """Input rows (the miss slot) of a host-plan rulebook."""
    i = int(plan[-1])
    if i == 0:
        return ex["voxels"].shape[1]
    return ex[f"plan_coords{i - 1}"].shape[1]
