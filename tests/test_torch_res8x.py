"""The port's residual nuScenes middle (``SpMiddleResNetFHD`` in
``configs/nuscenes/all.res8x.config``: OpenPCDet's VoxelResBackBone8x,
RPNV2 with a 10-class head) against the benchmark's plain reference
(``benchmark/reference/res8x.py``: plain PyTorch and NumPy, nothing of
the port) on seeded random weights, on the CPU.

The configuration is the benchmark's ``nusc_res8x`` at its published
widths and 0.1 x 0.1 x 0.2 m voxels on a +-3.2 m patch: a [41, 64, 64]
grid (an [8, 8] BEV map, every class's anchors on [1, 8, 8]) and 4 000
voxels. The weights are the benchmark's (``benchmark/res8x_weights.py``),
fitted on two frames of the seed, the one the tests serve among them,
as the cell fits them on the frames it serves. Tolerances as
``test_torch_mhead_reference.py``'s: the BEV map and each pred within
1e-4 of their largest magnitude, host arrays exact, the detections
through the reference's judge with the labels checked. The middle's
capacities are held to the reference's active sets of the generator's
10-sweep frames at the full grid, where the reference drops nothing.
"""

import json

import numpy as np
import pytest
import torch

from benchmark import common, res8x_weights
from benchmark.gen import nusc_scenes
from benchmark.reference import judge, multihead, res8x
from benchmark.tests.small_res8x import (VOXELS, small_res8x_config,
                                         small_res8x_frame)
from second_tpu_torch.core.inference import InferenceContext
from second_tpu_torch.models import sparse_middle as tsm
from second_tpu_torch.ops import cuda_sparse_conv, cuda_sparse_conv_dw
from second_tpu_torch.ops import sparse as tsp

CPU = torch.device("cpu")
PREDS_TOL = 1e-4
DET_TOL = 1e-3
SEED = 2 ** 31 + 23
MIDDLE = "SpMiddleResNetFHD"


def build_small_res8x(tmp_path, seed=SEED):
    """(config dict, InferenceContext on the CPU with the benchmark's
    weights for ``seed``, the weights)."""
    cfg = small_res8x_config(tmp_path)
    ctx = InferenceContext()
    ctx.build(cfg["repo_config"], CPU)
    net = ctx.parts["net"]
    net.eval()
    frames = [small_res8x_frame(np.random.default_rng([seed, i]))
              for i in (1, 2)]
    w = res8x_weights.make(net, cfg, seed, frames, CPU)
    net.load_state_dict(w, strict=True)
    return cfg, ctx, w


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg, ctx, w = build_small_res8x(tmp_path_factory.mktemp("res8x"))
    points = small_res8x_frame(np.random.default_rng([SEED, 1]))
    ref = res8x.request(cfg["model"], w, points, CPU, 100)
    return {"cfg": cfg, "ctx": ctx, "w": w, "points": points, "ref": ref}


def _err(got, ref):
    return judge.preds_err({"x": got}, {"x": ref})


def test_topology_is_the_published_backbone(setup):
    """conv_input, two blocks at 16, then per scale a strided conv and
    two blocks at 32, 64 and 128, then conv_out: every op sparse, the
    grid [41, 64, 64] -> [2, 8, 8], 256 BEV channels."""
    model = setup["cfg"]["model"]
    mid = setup["ctx"].parts["net"].middle_feature_extractor
    assert type(mid).__name__ == MIDDLE
    assert json.loads(json.dumps(mid.topology)) == model["middle_topology"]
    assert mid.dense_from_scale is None
    assert mid.wide_from == 9  # conv4
    scales = tsm.plan_scales(MIDDLE, (1, 40, 64, 64, 4), VOXELS)
    assert [s["out_shape"] for s in scales] == [
        (21, 32, 32), (11, 16, 16), (5, 8, 8), (2, 8, 8)]
    assert not any(s["dense"] for s in scales)
    names = {n for n, _ in mid.named_parameters()}
    assert "block10.conv1_w" in names and "block10.bn2.weight" in names
    assert mid.block10.conv2_w.shape == (27, 128, 128)
    assert mid.down12_w.shape == (3, 128, 128)


@pytest.mark.parametrize("route", ["device", "host"])
def test_bev_map_follows_the_reference(setup, route):
    """The middle's BEV map from the reference's voxels, its rulebooks
    built on the device (requests) or by the C++ planner (loaders)."""
    model = setup["cfg"]["model"]
    net = setup["ctx"].parts["net"]
    vox, counts, coords = setup["ref"]["net_in"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    scales, order = res8x.plan(model, t(coords).long(), CPU)
    nf = model["num_point_features"]
    feats = (t(vox)[..., :nf].sum(1)
             / t(counts).clamp(min=1)[:, None].float())
    with torch.no_grad():
        ref = res8x.middle(setup["w"], model, feats[order], scales)
        pad = np.full((VOXELS, 3), -1, np.int32)
        pad[:len(coords)] = coords
        pv = np.zeros((VOXELS,) + vox.shape[1:], np.float32)
        pv[:len(coords)] = vox
        pn = np.zeros(VOXELS, np.int32)
        pn[:len(coords)] = counts
        vf = net.voxel_feature_extractor(t(pv)[None], t(pn)[None],
                                         t(pad)[None])
        mid = net.middle_feature_extractor
        plan = None
        if route == "host":
            host = tsm.build_host_plan(pad, tsm.plan_scales(
                MIDDLE, mid.output_shape, VOXELS))
            plan = {k: t(v)[None] for k, v in host.items()}
        got = mid(vf, t(pad)[None], plan)
    assert got.shape == ref.shape == (1, 256, 8, 8)
    assert _err(got, ref) <= PREDS_TOL


def test_host_and_device_rulebooks_are_equal(setup):
    """Every scale's coords, subm and strided slots of the device
    builders equal the C++ planner's, for the frame in the planner's
    order and reversed."""
    coords = setup["ref"]["net_in"][2]
    pad = np.full((VOXELS, 3), -1, np.int32)
    pad[:len(coords)] = coords
    scales = tsm.plan_scales(MIDDLE, (1, 40, 64, 64, 4), VOXELS)
    plan, counts = tsm.build_host_plan(pad, scales, return_counts=True)
    batch = torch.from_numpy(np.stack([pad, pad[::-1].copy()]))
    dplan, dcounts = tsm.build_device_plan(tsp.from_voxel_coords(
        torch.zeros(2, VOXELS, 1), batch, (41, 64, 64)), scales)
    assert sorted(dplan) == sorted(plan) == sorted(
        [f"plan_subm{i}" for i in range(4)]
        + [f"plan_coords{i}" for i in range(4)]
        + [f"plan_conv{i}" for i in range(4)])
    for key, value in plan.items():
        for b in range(2):
            assert np.array_equal(dplan[key][b].numpy(), value), key
    want = np.array([counts[i] for i in sorted(counts)])
    for b in range(2):
        assert np.array_equal(dcounts[b].numpy(), want)
    assert np.all(want[:, 0] <= want[:, 1])


def test_host_arrays_and_anchors_equal_the_port(setup):
    ctx = setup["ctx"]
    ex = ctx.get_inference_input_dict({"token": "t"}, setup["points"])
    assert judge.prep_mismatch(ex, setup["ref"]["ex"]) == 0
    anc = multihead.anchors(setup["cfg"]["model"])
    assert len(anc) == 10 * 2 * 8 * 8
    assert np.array_equal(anc, ctx.parts["anchor_cache"]["anchors"])


def test_preds_follow_the_reference(setup):
    ctx = setup["ctx"]
    ex = ctx.get_inference_input_dict({"token": "t"}, setup["points"])
    preds = {k: v[0] for k, v in ctx._run(ex)[0].items()}
    ref = setup["ref"]["preds"]
    assert preds["cls_preds"].shape == (1280, 10)
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        assert preds[key].shape == ref[key].shape, key
        assert _err(preds[key], ref[key]) <= PREDS_TOL, key


def test_detections_and_labels_pass_the_judge(setup):
    model = setup["cfg"]["model"]
    tol = common.load_mix("nusc_voxel_sweep")["tolerance"]
    ctx = setup["ctx"]
    out = ctx.inference(ctx.get_inference_input_dict({"token": "t"},
                                                     setup["points"]))[0]
    labels = out["label_preds"]
    assert 0 < len(labels) <= model["nms"]["post_max"]
    assert len(set(labels.tolist())) > 1
    d_err, bad, why = multihead.judge(model, out["box3d_lidar"],
                                      out["scores"], labels,
                                      setup["ref"]["cand"], tol)
    assert bad == 0, why
    assert d_err <= DET_TOL


def test_detections_off_by_a_label_are_caught(setup):
    model = setup["cfg"]["model"]
    tol = common.load_mix("nusc_voxel_sweep")["tolerance"]
    ctx = setup["ctx"]
    out = ctx.inference(ctx.get_inference_input_dict({"token": "t"},
                                                     setup["points"]))[0]
    _, bad, why = multihead.judge(model, out["box3d_lidar"], out["scores"],
                                  (out["label_preds"] + 1) % 10,
                                  setup["ref"]["cand"], tol)
    assert bad > 0 and why["label"] > 0


def test_weights_keep_the_class_logits_off_saturation(setup):
    """On each frame the weights were fitted on, no class logit passes
    ``max_logit`` (where a float32 sigmoid still orders logits 1e-3
    apart); on the median frame the ``pre_max``-th best anchor scores
    ``top_score``. With a ``max_logit`` below the frames' reach, the
    class head is scaled down to meet it exactly."""
    cfg, w = setup["cfg"], setup["w"]
    model, assumed = cfg["model"], cfg["assumed"]
    frames = [small_res8x_frame(np.random.default_rng([SEED, i]))
              for i in (1, 2)]
    k = model["nms"]["pre_max"]

    def logits(w):
        out = []
        for pts in frames:
            preds = res8x.request(model, w, pts, CPU, 0)["preds"]
            out.append(preds["cls_preds"])
        return out

    got = logits(w)
    assert max(float(c.max()) for c in got) <= assumed["max_logit"] + 1e-4
    kth = sorted(float(torch.topk(c.amax(1), k).values[-1]) for c in got)
    level = np.log(assumed["top_score"] / (1 - assumed["top_score"]))
    assert np.median(kth) == pytest.approx(level, abs=1e-4)

    low = dict(cfg, assumed=dict(assumed, max_logit=2.0))
    net = setup["ctx"].parts["net"]
    tight = logits(res8x_weights.make(net, low, SEED, frames, CPU))
    assert max(float(c.max()) for c in tight) == pytest.approx(2.0,
                                                               abs=1e-4)


@pytest.mark.parametrize("seed", [7, 11, 2 ** 31 + 5])
def test_capacities_hold_the_generators_frames(seed):
    """At the full grid, the reference's active sets of the pool's two
    densest frame sizes (the most points, the most objects) of each seed
    stay within the middle's capacities at 60 000 voxels: the port drops
    no site that the reference keeps (overflow 0)."""
    config = common.load_config("nusc_res8x")
    model = config["model"]
    mix = common.load_mix("nusc_voxel_sweep")
    sizes = nusc_scenes.pool_sizes(mix)
    scales = tsm.plan_scales(MIDDLE, [1, *model["grid_zyx"], 4],
                             model["max_voxels"])
    caps = [s["out_cap"] for s in scales]
    densest = [max(range(len(sizes)), key=lambda j: sizes[j]),
               max(range(len(sizes)), key=lambda j: sizes[j][::-1])]
    for j in densest:
        pts = nusc_scenes.make_frame(np.random.default_rng([seed, 1, j]),
                                     *sizes[j])[0]
        _, (_, _, coords) = res8x.host_example(model, pts)
        assert len(coords) == model["max_voxels"]  # the cap is reached
        ref_scales, _ = res8x.plan(model, coords, CPU)
        active = [len(s["lin"]) for s in ref_scales[1:]]
        assert all(a <= c for a, c in zip(active, caps)), (active, caps)


def test_k1_bf16_and_k2_refuse_wide_widths():
    """Only fp32 K1 has the 128-wide instantiations: bf16 and the weight
    gradient above 64 channels raise, naming the queue that holds them,
    on any device; 64 still passes."""
    feat = torch.zeros(1, 8, 64)
    slots = torch.zeros(1, 8, 27, dtype=torch.int32)
    for cin, cout in ((64, 128), (128, 128), (128, 64)):
        f = torch.zeros(1, 8, cin)
        with pytest.raises(ValueError, match="ROADMAP.md queue 6"):
            cuda_sparse_conv.gather_gemm(
                f.bfloat16(), slots,
                torch.zeros(27, cin, cout, dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="ROADMAP.md queue 6"):
            cuda_sparse_conv_dw.sparse_conv_dw(f, slots,
                                               torch.zeros(1, 8, cout))
    out = cuda_sparse_conv.gather_gemm(feat.bfloat16(), slots,
                                       torch.zeros(27, 64, 64,
                                                   dtype=torch.bfloat16))
    assert out.shape == (1, 8, 64)
    dw = cuda_sparse_conv_dw.sparse_conv_dw(feat, slots,
                                            torch.zeros(1, 8, 64))
    assert dw.shape == (27, 64, 64)
    # fp32 K1's plain version takes the wide widths
    assert cuda_sparse_conv.gather_gemm(
        feat, slots, torch.zeros(27, 64, 128)).shape == (1, 8, 128)


def test_the_residual_middle_refuses_bf16_and_no_norm():
    shape = (1, 40, 64, 64, 4)
    with pytest.raises(ValueError, match="ROADMAP.md queue 6"):
        tsm.SpMiddleResNetFHD(shape, num_input_features=4,
                              compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="use_norm"):
        tsm.SpMiddleResNetFHD(shape, num_input_features=4, use_norm=False)
