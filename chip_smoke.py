"""Smoke run of the PyTorch/CUDA port (second_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths at the published width of
``configs/car.fhd.config``, with random weights from seed 0: car.fhd
inference (points -> detections) through ``InferenceContext``, and
car.fhd training steps at the train reader's batch 8 through
``train.state.make_train_step``. Phases, each printed as it runs:

  1. the card's name and power limit (nvidia-smi) and the nvcc build of
     the four kernels K1 (sparse conv), K2 (its weight gradient), K3
     (rotated IoU), K4 (greedy NMS);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (K1 on the rulebooks of a
     ``make_kitti_scene`` frame, K3 at [1000, 5] x [1000, 5], K4 at
     n = 1000): max error, kernel ms and plain ms (CUDA events); for
     each K1 conv also two calls bitwise equal, the 64-row tiles it
     skips as empty and the (tile, offset) pairs it runs (counted from
     the slots with plain torch), the TFLOP/s of the hits, and two
     bounds: fp32 at 67 TFLOP/s and 3xTF32 (three TF32 products per
     product at 495 TFLOP/s);
  3. the slice: 4 requests from ``make_kitti_scene(RandomState(i))``,
     each with its detection count and CUDA-synchronised ms; every
     kernel's launch counter must have risen in this phase;
  4. correctness: frame 0 again with the network on the CPU (the plain
     versions) -> preds agree, detections agree, NMS fed the same preds
     on both devices agrees, and the CPU's NMS candidates run through
     K3 and K4 on the card keep exactly the CPU's boxes;
  5. a per-stage breakdown of frame 0 on the card;
  6. the backward kernels at the training shapes, on the rulebooks of a
     batch of 8 ``make_kitti_scene`` frames prepared by the train reader
     (capacity 17000 voxels): for each of the 10 sparse convs K2 against
     its plain version (max error, kernel and plain ms, two calls
     bitwise equal), and K1's forward and input gradient through the
     autograd Function against autograd through the plain version (max
     error; kernel and plain ms of each; the forward bitwise equal to a
     second call); for each, the skips, the TFLOP/s of the hits and both
     bounds, as in phase 2;
  7. the training slice: the full-width train step on the card, 10
     steps on that batch (device ms, loss, lr, peak memory; losses
     finite and falling; K1 and K2 launched), a per-part breakdown of
     one step, and one step at batch 1 against the same step on the CPU
     with the plain kernels (loss and every gradient).

Then one JSON line with the kernels (K1's ``ms``, ``plain_ms`` and bounds
are sums over the inference frame's 10 sparse convs, K2's over the
training batch's 10; ``bound_ms`` is the fp32 bound and
``bound_tf32x3_ms`` the 3xTF32 one; K1's ``max_abs_err`` is its largest over phases 2
and 6; ``launches`` count the main paths' runs, phases 3
and 7, with ``launches_by_path`` splitting them), and as the last line
``{"ok": true, "device": {...}}``. TF32 is off for the whole run (the
slices are fp32). Any failed check raises, which exits non-zero; without
a CUDA device the script exits 1 before printing any result.
"""

import copy
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.builders.network_builder import build_network
from second_tpu_torch.configs import load_pipeline_config
from second_tpu_torch.core.inference import (
    InferenceContext,
    example_to_device,
)
from second_tpu_torch.csrc import build
from second_tpu_torch.data import make_kitti_scene, merge_second_batch
from second_tpu_torch.models.voxelnet import compute_loss, init_weights, predict
from second_tpu_torch.ops import (
    cuda_iou,
    cuda_nms,
    cuda_sparse_conv,
    cuda_sparse_conv_dw,
)
from second_tpu_torch.ops.sparse import SparseConvFunction, transpose_rulebook
from second_tpu_torch.train import optimizer as opt_builder
from second_tpu_torch.train.state import forward_loss, make_train_step

CONFIG = "configs/car.fhd.config"
N_FRAMES = 4
# K1: fp32 sums of K*Cin products in another order; K3: fp32 rounding of
# the same arithmetic; K4: a keep mask, exact
K1_TOL = 1e-4
K3_TOL = 1e-5
# the whole network on the card against the CPU: max |diff| over
# max |value| of each pred map (cuDNN and CPU convs sum in other orders)
PREDS_REL_TOL = 1e-3
# detections matched between devices (same box within 1e-2, score within
# 1e-3). Random weights score the top 1000 candidates alike (0.5 + a few
# ulps), so the devices' 1-ulp sigmoid differences reorder them and
# greedy NMS keeps other near-duplicates: on H100 frame 0 matches 37 of
# 39 both end to end and on the same preds. Fed the CPU's candidates in
# the CPU's order, K3 and K4 on the card must agree exactly (checked)
NMS_MATCH_MIN = 0.9
FRAME_MATCH_MIN = 0.9
# K2 and K1's input gradient at batch 8: fp32 sums of up to ~10^5
# products per element in another order, against the largest magnitude
K2_TOL = 1e-4
DGRAD_TOL = 1e-4
# one train step at batch 1: the card's loss against the CPU's (fp32,
# relative), and every gradient of the card against the same step in
# float64 on the CPU (relative L2 error). An fp32 gradient of this
# network is not good to 1e-3 of its largest magnitude on any device:
# the CPU's own fp32 step is 1.2e-2 of it off its float64 step (batch
# norm's backward cancels, and fp32 rounding picks the gate of ReLU
# inputs near zero); in L2 the two fp32 steps are within 6e-3 of
# float64 (NVIDIA H100 80GB HBM3 at 700 W, this script's phase 7)
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_GRAD_L2_TOL = 2e-2
TRAIN_BATCH = 8
TRAIN_STEPS = 10

# the card's published peaks (H100 SXM at 700 W): fp32 outside the
# tensor cores, TF32 on them and HBM bandwidth, for each kernel's least
# time
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# K1 and K2 run each fp32 product as three TF32 products (3xTF32)
TF32_PASSES = 3
# rows of a K1 tile (TM, csrc/sparse_conv.cu) and of a K2 tile (TR,
# csrc/sparse_conv_dw.cu)
TILE_ROWS = 64
# K3's arithmetic per box pair, counted in csrc/rotated_iou.cu's header
K3_OPS_PER_PAIR = 400
# K4: one compare and one select per (i, j > i) pair of the sweep
K4_OPS_PER_PAIR = 2

KERNELS = [
    ("sparse_conv_gather_gemm", cuda_sparse_conv,
     "second_tpu_torch/csrc/sparse_conv.cu",
     "second_tpu/ops/banded_sparse.py:295"),
    ("sparse_conv_weight_grad", cuda_sparse_conv_dw,
     "second_tpu_torch/csrc/sparse_conv_dw.cu",
     "second_tpu/ops/banded_sparse.py:457"),
    ("rotated_iou", cuda_iou, "second_tpu_torch/csrc/rotated_iou.cu",
     "second_tpu/ops/pallas_iou.py:124"),
    ("greedy_nms", cuda_nms, "second_tpu_torch/csrc/greedy_nms.cu",
     "second_tpu/ops/pallas_nms.py:44"),
]
# the kernels each main path must launch
PATH_KERNELS = {
    "inference": ("sparse_conv_gather_gemm", "rotated_iou", "greedy_nms"),
    "train": ("sparse_conv_gather_gemm", "sparse_conv_weight_grad"),
}
# the 10 sparse convs of SpMiddleFHD (scales 0-2): (weight, rulebook,
# submanifold)
SPARSE_CONVS = [
    ("subm0_w", "plan_subm0", True), ("subm1_w", "plan_subm0", True),
    ("down2_w", "plan_conv0", False), ("subm3_w", "plan_subm1", True),
    ("subm4_w", "plan_subm1", True), ("down5_w", "plan_conv1", False),
    ("subm6_w", "plan_subm2", True), ("subm7_w", "plan_subm2", True),
    ("subm8_w", "plan_subm2", True), ("down9_w", "plan_conv2", False)]


def bound_ms(nbytes, ops):
    """The least time (ms) of work that moves ``nbytes`` and does ``ops``
    fp32 operations on the card, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tf32x3_bound_ms(nbytes, ops):
    """The least time (ms) of the same work with every product run as
    ``TF32_PASSES`` TF32 products on the tensor cores (165 TFLOP/s
    effective): the bound of the instructions K1 and K2 use."""
    return max(nbytes / PEAK_HBM_BYTES,
               TF32_PASSES * ops / PEAK_TF32_FLOPS) * 1e3


def tile_stats(slots, vin, flat=False):
    """K1's (or, ``flat``, K2's: tiles over the B*Vout rows) skips on
    these rulebooks, from the slots with plain torch on the device: the
    64-row tiles with no hit at any offset (skipped as empty) and the
    (tile, offset) pairs with a hit (the ones run), each with its total."""
    b, vout, k = slots.shape
    hit = (slots >= 0) & (slots < vin)
    if flat:
        hit, b, vout = hit.reshape(1, b * vout, k), 1, b * vout
    pad = -vout % TILE_ROWS
    if pad:
        hit = torch.cat([hit, hit.new_zeros(b, pad, k)], 1)
    pairs = hit.reshape(b, -1, TILE_ROWS, k).any(2)
    return {"tiles": pairs.shape[0] * pairs.shape[1],
            "empty": int((~pairs.any(-1)).sum()),
            "pairs": int(pairs.sum()), "all_pairs": pairs.numel()}


def skips(st):
    return (f"tiles empty {st['empty']} of {st['tiles']}, (tile, offset) "
            f"pairs run {st['pairs']} of {st['all_pairs']}")


def gather_conv_bound(b, vin, cin, slots, cout, weight_grad):
    """Bytes and operations of one sparse conv (K1) or its weight
    gradient (K2) on these rulebooks: each input read once, each output
    written once, 2*Cin*Cout operations per hit (slot < Vin)."""
    _, vout, k = slots.shape
    hits = int((slots < vin).sum().item())
    if weight_grad:  # feat, slots, dout in; dW out
        nbytes = 4 * (b * vin * cin + b * vout * k + b * vout * cout
                      + k * cin * cout)
    else:  # feat, slots, W in; out
        nbytes = 4 * (b * vin * cin + b * vout * k + k * cin * cout
                      + b * vout * cout)
    return nbytes, 2 * hits * cin * cout


def conv_rows(example):
    """Input rows of each rulebook: scale i's capacity."""
    rows = {"plan_subm0": example["voxels"].shape[1]}
    for i in range(3):
        rows[f"plan_conv{i}"] = rows[f"plan_subm{i}"]
        if i < 2:
            rows[f"plan_subm{i + 1}"] = example[f"plan_conv{i}"].shape[1]
    return rows


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source
        list(pool.map(lambda kernel: kernel[1]._load(), KERNELS))
    log(f"build: {time.perf_counter() - t0:.3f} s for "
        f"{', '.join(m.KERNEL for _, m, _, _ in KERNELS)} "
        f"(nvcc, {' '.join(build.ARCH_FLAGS)})")
    for _, module, _, _ in KERNELS:
        for line in build.ptxas_report(module.KERNEL).splitlines():
            log(f"  {module.KERNEL}: {line.strip()}")


def phase_kernels(ctx, device):
    """Each kernel against its plain version at the main path's shapes."""
    results = {}
    example = ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(100))[0])
    net = ctx.parts["net"]
    mid = net.middle_feature_extractor
    g = torch.Generator().manual_seed(0)
    errs, k_ms, p_ms, b_ms, t_ms = [], 0.0, 0.0, {}, 0.0
    in_rows = conv_rows(example)
    for wname, pname, _ in SPARSE_CONVS:
        w = getattr(mid, wname).detach()
        k, cin, cout = w.shape
        slots = torch.from_numpy(example[pname].astype(np.int32)).to(device)
        feat = torch.randn(1, in_rows[pname], cin, generator=g).to(device)
        cb, co = gather_conv_bound(1, in_rows[pname], cin, slots, cout, False)
        cms, cby = bound_ms(cb, co)
        tms = tf32x3_bound_ms(cb, co)
        b_ms[cby] = b_ms.get(cby, 0.0) + cms
        t_ms += tms
        out = cuda_sparse_conv.gather_gemm(feat, slots, w)
        ref = cuda_sparse_conv.gather_gemm_plain(feat, slots, w)
        err = (out - ref).abs().max().item()
        tol = K1_TOL * max(1.0, ref.abs().max().item())
        check(err <= tol, f"K1 {wname}: max err {err} > {tol}")
        check(torch.equal(out, cuda_sparse_conv.gather_gemm(feat, slots, w)),
              f"K1 {wname}: two calls differ")
        kms = cuda_ms(lambda: cuda_sparse_conv.gather_gemm(feat, slots, w))
        pms = cuda_ms(
            lambda: cuda_sparse_conv.gather_gemm_plain(feat, slots, w))
        errs.append(err)
        k_ms += kms
        p_ms += pms
        log(f"K1 {wname}: rows {tuple(feat.shape[1:])} -> "
            f"{tuple(slots.shape[1:])} x {cout}, max err {err:.3e}, "
            f"two calls bitwise equal, kernel {kms:.4f} ms, plain "
            f"{pms:.4f} ms, bound fp32 {cms:.4f} ms ({cby}) / 3xTF32 "
            f"{tms:.4f} ms; {co / 1e9:.3f} GFLOP of hits at "
            f"{co / kms / 1e9:.3f} TFLOP/s, {cb / 1e6:.1f} MB; "
            f"{skips(tile_stats(slots, in_rows[pname]))}")
    results["sparse_conv_gather_gemm"] = {
        "max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": sum(b_ms.values()),
        "bound_by": max(b_ms, key=b_ms.get), "bound_tf32x3_ms": t_ms,
        "library_ms": None}
    log(f"K1 frame total (10 convs): kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, bound fp32 {sum(b_ms.values()):.4f} ms / "
        f"3xTF32 {t_ms:.4f} ms")

    rng = np.random.RandomState(1)
    centers = np.stack([rng.uniform(0, 70.4, 100), rng.uniform(-40, 40, 100)],
                       1).repeat(10, 0) + rng.normal(0, 1.0, (1000, 2))
    boxes = np.concatenate([
        centers, rng.normal([1.6, 3.9], 0.1, (1000, 2)),
        rng.uniform(-np.pi, np.pi, (1000, 1))], 1).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(device)
    iou = cuda_iou.rotated_iou_matrix(boxes, boxes)
    ref = cuda_iou.rotated_iou_matrix_plain(boxes, boxes)
    err = (iou - ref).abs().max().item()
    check(err <= K3_TOL, f"K3: max err {err} > {K3_TOL}")
    kms = cuda_ms(lambda: cuda_iou.rotated_iou_matrix(boxes, boxes))
    pms = cuda_ms(lambda: cuda_iou.rotated_iou_matrix_plain(boxes, boxes))
    n = boxes.shape[0]
    k3_bound, k3_by = bound_ms(4 * (2 * n * 5 + n * n),
                               K3_OPS_PER_PAIR * n * n)
    results["rotated_iou"] = {
        "max_abs_err": err, "ms": kms, "plain_ms": pms,
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None}
    log(f"K3 [1000,5]x[1000,5]: max err {err:.3e}, kernel {kms:.4f} ms, "
        f"plain {pms:.4f} ms, pairs overlapping "
        f"{(ref > 0).float().mean().item():.4f}")

    valid = torch.from_numpy(rng.uniform(size=1000) < 0.9).to(device)
    keep = cuda_nms.greedy_suppress(ref, valid, 0.01)
    keep_ref = cuda_nms.greedy_suppress_plain(ref, valid, 0.01)
    mismatches = int((keep != keep_ref).sum().item())
    check(mismatches == 0, f"K4: {mismatches} keep flags differ")
    kms = cuda_ms(lambda: cuda_nms.greedy_suppress(ref, valid, 0.01))
    pms = cuda_ms(lambda: cuda_nms.greedy_suppress_plain(ref, valid, 0.01),
                  iters=3, warmup=1)
    k4_bound, k4_by = bound_ms(4 * n * n + 2 * n,
                               K4_OPS_PER_PAIR * n * (n - 1) // 2)
    results["greedy_nms"] = {
        "max_abs_err": 0.0, "ms": kms, "plain_ms": pms,
        "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None}
    log(f"K4 n=1000: keep mismatches 0 (kept {int(keep.sum())}), "
        f"kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {k4_bound:.5f} ms "
        f"({k4_by}); K3 bound {k3_bound:.5f} ms ({k3_by})")
    return results


def reset_launches():
    for _, module, _, _ in KERNELS:
        module.launches = 0


def read_launches(path):
    """The launch counts since :func:`reset_launches`; each kernel of
    ``path`` must have launched."""
    launches = {name: module.launches for name, module, _, _ in KERNELS}
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0,
              f"the {path} path never launched {name}")
    return launches


def phase_slice(ctx):
    """4 requests through the port's entry points; returns the counts of
    kernel launches made during them."""
    reset_launches()
    for i in range(N_FRAMES):
        points = make_kitti_scene(np.random.RandomState(i))[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        example = ctx.get_inference_input_dict({}, points)
        t1 = time.perf_counter()
        dets = ctx.inference(example)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        boxes = dets[0]["box3d_lidar"]
        check(boxes.ndim == 2 and boxes.shape[1] == 7
              and np.isfinite(boxes).all(), f"frame {i}: bad boxes")
        active = example["sparse_active_counts"][0].tolist()
        log(f"frame {i}: {len(points)} points, "
            f"{int(example['num_voxels'][0, 0])} voxels, active per stage "
            f"{active}, {len(boxes)} detections, host prep "
            f"{(t1 - t0) * 1e3:.3f} ms, device inference "
            f"{(t2 - t1) * 1e3:.3f} ms, total {(t2 - t0) * 1e3:.3f} ms")
    launches = read_launches("inference")
    log(f"launches in the {N_FRAMES} frames: {launches}")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def _match(a, b):
    """Detections of ``a`` paired with those of ``b`` (box within 1e-2,
    score within 1e-3): the share paired over the larger count, and the
    unpaired rows of ``a`` and of ``b``."""
    n = max(len(a["scores"]), len(b["scores"]))
    used = np.zeros(len(b["scores"]), bool)
    lone = []
    for i, (box, score) in enumerate(zip(a["box3d_lidar"], a["scores"])):
        close = (np.abs(b["box3d_lidar"] - box).max(1) < 1e-2) & (
            np.abs(b["scores"] - score) < 1e-3) & ~used
        if close.any():
            used[np.argmax(close)] = True
        else:
            lone.append(i)
    frac = 1.0 if n == 0 else (len(a["scores"]) - len(lone)) / n
    return frac, lone, np.flatnonzero(~used).tolist()


def _ragged(dets):
    valid = dets["valid"][0].cpu().numpy()
    return {k: dets[k][0].cpu().numpy()[valid]
            for k in ("box3d_lidar", "scores")}


def _nms_steps(spec, preds, anchors, device):
    """predict's steps for frame 0 of ``preds`` on ``device``, up to the
    keep mask (car.fhd: one class, background encoded as zeros)."""
    box = spec.decode(preds["box_preds"][0].to(device), anchors[0].to(device))
    scores = torch.sigmoid(preds["cls_preds"][0].to(device)).max(-1).values
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    k = spec.nms_pre_max_sizes[0]
    top_s, top_i = top_s[:k], top_i[:k]
    cand = box[top_i][:, [0, 1, 3, 4, 6]].contiguous()
    iou = cuda_iou.rotated_iou_matrix(cand, cand)
    valid = top_s >= spec.nms_score_thresholds[0]
    keep = cuda_nms.greedy_suppress(iou, valid, spec.nms_iou_thresholds[0])
    return {"box": box.cpu(), "scores": scores.cpu(), "top_s": top_s.cpu(),
            "top": top_i.cpu(), "cand": cand, "iou": iou.cpu(),
            "valid": valid.cpu(), "keep": keep.cpu()}


def _nms_disagreement(spec, preds, anchors, device):
    """Where predict on the same preds parts ways between the card and
    the CPU, step by step. Returns, for the CPU's own candidates run
    through K3 and K4 on the card, the valid pairs whose IoU falls on
    the other side of the threshold and the keep flags that differ."""
    thr = spec.nms_iou_thresholds[0]
    cpu = _nms_steps(spec, preds, anchors, "cpu")
    dev = _nms_steps(spec, preds, anchors, device)
    log(f"reference: same preds, decoded boxes max |diff| "
        f"{(cpu['box'] - dev['box']).abs().max().item():.3e}, scores "
        f"{(cpu['scores'] - dev['scores']).abs().max().item():.3e}, "
        f"candidate scores {cpu['top_s'][-1].item():.9g}.."
        f"{cpu['top_s'][0].item():.9g}, top-k ranks that differ "
        f"{int((cpu['top'] != dev['top']).sum())} of {len(cpu['top'])}, "
        f"keep flags that differ {int((cpu['keep'] != dev['keep']).sum())}")
    # the same candidates in the same order through K3 and K4 on the card
    cand = cpu["cand"].to(device)
    iou = cuda_iou.rotated_iou_matrix(cand, cand)
    keep = cuda_nms.greedy_suppress(iou, cpu["valid"].to(device), thr).cpu()
    iou = iou.cpu()
    both = cpu["valid"][:, None] & cpu["valid"][None, :]
    flip = ((iou > thr) != (cpu["iou"] > thr)) & both
    pairs = (flip & torch.ones_like(flip).triu(1)).nonzero().tolist()
    keep_diff = int((keep != cpu["keep"]).sum())
    log(f"reference: the CPU's candidates through K3 and K4 on the card: "
        f"IoU max |diff| {(iou - cpu['iou'])[both].abs().max().item():.3e}, "
        f"valid pairs on opposite sides of {thr}: {len(pairs)}, keep flags "
        f"that differ {keep_diff}")
    for i, j in pairs[:4]:
        log(f"  ranks {i},{j}: card IoU {iou[i, j].item():.9g}, CPU "
            f"{cpu['iou'][i, j].item():.9g}; boxes (x, y, w, l, r) "
            f"{cpu['cand'][i].tolist()} / {cpu['cand'][j].tolist()}")
    return len(pairs), keep_diff


def phase_reference(ctx):
    """Frame 0 on the card against the network on the CPU."""
    example = ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(0))[0])
    preds, dets = ctx.run(example)
    cpu = InferenceContext()
    cpu.build(CONFIG, device="cpu")
    cpu.parts["net"].load_state_dict(ctx.parts["net"].state_dict())
    t0 = time.perf_counter()
    preds_cpu, dets_cpu = cpu.run(example)
    log(f"reference: frame 0 on the CPU took "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    for key in preds:
        ref = preds_cpu[key]
        rel = ((preds[key].cpu() - ref).abs().max()
               / ref.abs().max().clamp(min=1e-12)).item()
        check(rel <= PREDS_REL_TOL,
              f"{key}: card vs CPU rel err {rel} > {PREDS_REL_TOL}")
        log(f"reference: {key} {tuple(ref.shape)} card vs CPU rel err "
            f"{rel:.3e}")
    frac, _, _ = _match(_ragged(dets), _ragged(dets_cpu))
    log(f"reference: detections card {int(dets['valid'].sum())}, CPU "
        f"{int(dets_cpu['valid'].sum())}, matched {frac:.4f}")
    check(frac >= FRAME_MATCH_MIN,
          f"detections matched {frac} < {FRAME_MATCH_MIN}")
    # NMS alone: the CPU's preds decoded and suppressed on both devices
    anchors = torch.from_numpy(example["anchors"].astype(np.float32))
    same_cpu = predict(cpu.parts["spec"], preds_cpu, {"anchors": anchors})
    same_dev = predict(ctx.parts["spec"],
                       {k: v.to(ctx.device) for k, v in preds_cpu.items()},
                       {"anchors": anchors.to(ctx.device)})
    same_dev, same_cpu = _ragged(same_dev), _ragged(same_cpu)
    frac, lone_dev, lone_cpu = _match(same_dev, same_cpu)
    log(f"reference: predict on the same preds, card "
        f"{len(same_dev['scores'])} vs CPU {len(same_cpu['scores'])} "
        f"detections, matched {frac:.4f}")
    for side, dets_, lone in (("card", same_dev, lone_dev),
                              ("CPU", same_cpu, lone_cpu)):
        for i in lone:
            log(f"  only on the {side}: score {dets_['scores'][i]:.6f}, box "
                f"{dets_['box3d_lidar'][i].tolist()}")
    check(frac >= NMS_MATCH_MIN,
          f"same-preds predict matched {frac} < {NMS_MATCH_MIN}")
    straddles, keep_diff = _nms_disagreement(
        ctx.parts["spec"], preds_cpu, anchors, ctx.device)
    check(straddles == 0 and keep_diff == 0,
          f"K3/K4 on the CPU's candidates: {straddles} IoU pairs straddle "
          f"the threshold, {keep_diff} keep flags differ")
    check(int(dets["valid"].sum()) > 0, "frame 0 produced no detections")


def phase_breakdown(ctx):
    """Device ms of each stage of frame 0 (synchronised, mean of 5)."""
    example = ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(0))[0])
    net, spec = ctx.parts["net"], ctx.parts["spec"]
    ex = example_to_device(example, ctx.device)
    plan = {k: v for k, v in ex.items() if k.startswith("plan_")}
    with torch.no_grad():
        vf = net.voxel_feature_extractor(ex["voxels"], ex["num_points"],
                                         ex["coordinates"])
        bev = net.middle_feature_extractor(vf, ex["coordinates"], plan)
        preds = net(ex["voxels"], ex["num_points"], ex["coordinates"], plan)
        stages = {
            "h2d": lambda: example_to_device(example, ctx.device),
            "vfe": lambda: net.voxel_feature_extractor(
                ex["voxels"], ex["num_points"], ex["coordinates"]),
            "middle": lambda: net.middle_feature_extractor(
                vf, ex["coordinates"], plan),
            "rpn": lambda: net.rpn(bev),
            "predict": lambda: predict(spec, preds, ex),
        }
        parts = {name: cuda_ms(fn, iters=5, warmup=2)
                 for name, fn in stages.items()}
    log("breakdown (device ms, frame 0): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))


def train_input(i):
    """Frame i of ``make_kitti_scene`` as the train reader hands it to
    ``prep_pointcloud``: points with their boxes as annotations."""
    points, boxes, names = make_kitti_scene(np.random.RandomState(i))
    return {"lidar": {"points": points,
                      "annotations": {"boxes": boxes, "names": names}}}


def prepare_train_batch(prep):
    """Host preparation of one batch of ``TRAIN_BATCH`` frames (the
    augmentation draws from np.random, seeded here)."""
    np.random.seed(0)
    t0 = time.perf_counter()
    batch = merge_second_batch(
        [prep(input_dict=train_input(i)) for i in range(TRAIN_BATCH)])
    ms = (time.perf_counter() - t0) * 1e3
    log(f"train batch: host preparation {ms:.3f} ms for {TRAIN_BATCH} "
        f"frames ({ms / TRAIN_BATCH:.3f} ms per frame), voxels per frame "
        f"{batch['num_voxels'][:, 0].tolist()}, positive anchors "
        f"{int((batch['labels'] > 0).sum())}, active per stage "
        f"{batch['sparse_active_counts'][:, :, 0].tolist()}")
    return batch


def phase_backward_kernels(net, batch, device):
    """K2, K1's forward and K1's input gradient at the training shapes,
    per sparse conv: against the plain versions, K2 twice for bitwise
    equality. Returns K2's results for the kernels line (ms summed over
    the 10 convs) and K1's largest error here."""
    mid = net.middle_feature_extractor
    rows = conv_rows(batch)
    b = TRAIN_BATCH
    g = torch.Generator().manual_seed(1)
    errs, k1_errs, sums, b_ms = [], [], {}, {}
    for wname, pname, subm in SPARSE_CONVS:
        w = getattr(mid, wname).detach()
        k, cin, cout = w.shape
        vin = rows[pname]
        slots = torch.from_numpy(batch[pname].astype(np.int32)).to(device)
        vout = slots.shape[1]
        feat = torch.randn(b, vin, cin, generator=g).to(device)
        dout = torch.randn(b, vout, cout, generator=g).to(device)
        dw = cuda_sparse_conv_dw.sparse_conv_dw(feat, slots, dout)
        dw2 = cuda_sparse_conv_dw.sparse_conv_dw(feat, slots, dout)
        check(torch.equal(dw, dw2), f"K2 {wname}: two calls differ")
        ref = cuda_sparse_conv_dw.sparse_conv_dw_plain(feat, slots, dout)
        err = (dw - ref).abs().max().item()
        tol = K2_TOL * ref.abs().max().item()
        check(err <= tol, f"K2 {wname}: max err {err} > {tol}")
        errs.append(err)

        f = feat.clone().requires_grad_()
        out = SparseConvFunction.apply(f, w, slots, subm)
        check(torch.equal(out.detach(),
                          cuda_sparse_conv.gather_gemm(feat, slots, w)),
              f"K1 forward {wname}: two calls differ")
        (dfeat,) = torch.autograd.grad((out * dout).sum(), f)
        fp = feat.clone().requires_grad_()
        out_p = cuda_sparse_conv.gather_gemm_plain(fp, slots, w)
        (dfeat_p,) = torch.autograd.grad((out_p * dout).sum(), fp)
        ferr = (out - out_p).abs().max().item()
        ftol = K1_TOL * max(1.0, out_p.abs().max().item())
        check(ferr <= ftol, f"K1 forward {wname}: max err {ferr} > {ftol}")
        derr = (dfeat - dfeat_p).abs().max().item()
        dtol = DGRAD_TOL * dfeat_p.abs().max().item()
        check(derr <= dtol, f"K1 input grad {wname}: max err {derr} > {dtol}")
        k1_errs += [ferr, derr]
        del out, out_p, dfeat, dfeat_p, f, fp

        # what the Function's backward launches: K1 over the mirrored
        # (subm) or transposed (strided) rulebook
        if subm:
            st, w_b = slots, w.flip(0).transpose(1, 2).contiguous()
        else:
            st = transpose_rulebook(slots, vin)
            w_b = w.transpose(1, 2).contiguous()
        times = {
            "k2": cuda_ms(lambda: cuda_sparse_conv_dw.sparse_conv_dw(
                feat, slots, dout), iters=10, warmup=2),
            "k2_plain": cuda_ms(lambda: cuda_sparse_conv_dw.sparse_conv_dw_plain(
                feat, slots, dout), iters=5, warmup=1),
            "k1_fwd": cuda_ms(lambda: cuda_sparse_conv.gather_gemm(
                feat, slots, w), iters=10, warmup=2),
            "k1_dgrad": cuda_ms(lambda: cuda_sparse_conv.gather_gemm(
                dout, st, w_b), iters=10, warmup=2),
            "k1_fwd_plain": cuda_ms(lambda: cuda_sparse_conv.gather_gemm_plain(
                feat, slots, w), iters=5, warmup=1),
            "k1_dgrad_plain": cuda_ms(
                lambda: cuda_sparse_conv.gather_gemm_plain(dout, st, w_b),
                iters=5, warmup=1),
        }
        for key, v in times.items():
            sums[key] = sums.get(key, 0.0) + v
        cb, co = gather_conv_bound(b, vin, cin, slots, cout, True)
        cms, cby = bound_ms(cb, co)
        b_ms[cby] = b_ms.get(cby, 0.0) + cms
        # K1's forward and input gradient do the same hits' products as K2
        # on these inputs; the input gradient reads dout, writes [B, Vin, Cin]
        fwd = gather_conv_bound(b, vin, cin, slots, cout, False)
        dgr = gather_conv_bound(b, vout, cout, st, cin, False)
        fms, fby = bound_ms(*fwd)
        bounds = {"k2_bound": cms, "k2_bound_t": tf32x3_bound_ms(cb, co),
                  "k1_bound": fms, "k1_bound_t": tf32x3_bound_ms(*fwd),
                  "k1_dgrad_bound": bound_ms(*dgr)[0],
                  "k1_dgrad_bound_t": tf32x3_bound_ms(*dgr)}
        for key, v in bounds.items():
            sums[key] = sums.get(key, 0.0) + v
        tflops = {key: co / times[key] / 1e9
                  for key in ("k2", "k1_fwd", "k1_dgrad")}
        log(f"K2 {wname}: [{b}, {vin}, {cin}] x [{b}, {vout}, {k}] x "
            f"[{b}, {vout}, {cout}], max err {err:.3e} (of "
            f"{ref.abs().max().item():.3e}), two calls bitwise equal, "
            f"kernel {times['k2']:.4f} ms, plain {times['k2_plain']:.4f} ms, "
            f"bound fp32 {cms:.4f} ms ({cby}) / 3xTF32 "
            f"{bounds['k2_bound_t']:.4f} ms; {co / 1e9:.3f} GFLOP of hits "
            f"at {tflops['k2']:.3f} TFLOP/s; "
            f"{skips(tile_stats(slots, vin, flat=True))}")
        log(f"K1 {wname}: forward max err {ferr:.3e}, two calls bitwise "
            f"equal, {times['k1_fwd']:.4f} ms (plain "
            f"{times['k1_fwd_plain']:.4f}, bound fp32 {fms:.4f} ms ({fby}) / "
            f"3xTF32 {bounds['k1_bound_t']:.4f}, {tflops['k1_fwd']:.3f} "
            f"TFLOP/s; {skips(tile_stats(slots, vin))}); input grad max "
            f"err {derr:.3e}, {times['k1_dgrad']:.4f} ms (plain "
            f"{times['k1_dgrad_plain']:.4f}, bound fp32 "
            f"{bounds['k1_dgrad_bound']:.4f} / 3xTF32 "
            f"{bounds['k1_dgrad_bound_t']:.4f}, {tflops['k1_dgrad']:.3f} "
            f"TFLOP/s; {skips(tile_stats(st, vout))})")
        del feat, dout, ref, dw, dw2
    torch.cuda.empty_cache()
    log(f"backward kernels, batch {b}, 10 convs: K2 {sums['k2']:.4f} ms "
        f"(plain {sums['k2_plain']:.4f}, bound fp32 {sums['k2_bound']:.4f} / "
        f"3xTF32 {sums['k2_bound_t']:.4f}), K1 forward "
        f"{sums['k1_fwd']:.4f} ms (plain {sums['k1_fwd_plain']:.4f}, bound "
        f"fp32 {sums['k1_bound']:.4f} / 3xTF32 {sums['k1_bound_t']:.4f}), "
        f"K1 input grad {sums['k1_dgrad']:.4f} ms (plain "
        f"{sums['k1_dgrad_plain']:.4f}, bound fp32 "
        f"{sums['k1_dgrad_bound']:.4f} / 3xTF32 "
        f"{sums['k1_dgrad_bound_t']:.4f})")
    return {"max_abs_err": max(errs), "ms": sums["k2"],
            "plain_ms": sums["k2_plain"], "bound_ms": sum(b_ms.values()),
            "bound_by": max(b_ms, key=b_ms.get),
            "bound_tf32x3_ms": sums["k2_bound_t"],
            "library_ms": None}, max(k1_errs)


def loss_and_grads(net, spec, example):
    """Loss and gradients of one training forward on a copy of ``net``
    (its batch statistics stay as they are)."""
    net = copy.deepcopy(net)
    loss = forward_loss(net, spec, example)["loss"]
    names, params = zip(*net.named_parameters())
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, params)))


def train_reference(cfg, parts, batch, device):
    """One step's loss and gradients at batch 1 on the card against the
    same network on the CPU (the plain kernels), in fp32 and float64."""
    batch1 = {k: v[:1] for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    loss_d, grads_d = loss_and_grads(
        parts["net"], parts["spec"], example_to_device(batch1, device))
    cpu = build_network(cfg, "cpu")
    cpu["net"].load_state_dict(parts["net"].state_dict())
    ex = example_to_device(batch1, "cpu")
    t0 = time.perf_counter()
    loss_c, grads_c = loss_and_grads(cpu["net"], cpu["spec"], ex)
    ex64 = {k: v.double() if v.is_floating_point() else v
            for k, v in ex.items()}
    _, grads_64 = loss_and_grads(cpu["net"].double(), cpu["spec"], ex64)
    log(f"train reference: batch 1 on the CPU in fp32 and float64 took "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    rel = abs(loss_d - loss_c) / abs(loss_c)
    log(f"train reference: batch 1 loss card {loss_d:.6f}, CPU "
        f"{loss_c:.6f} (rel {rel:.3e})")
    check(rel <= TRAIN_LOSS_REL_TOL,
          f"train loss card {loss_d} vs CPU {loss_c}: rel {rel}")

    def errors(grads):
        """name -> (max |g - g64| / max |g64|, ||g - g64|| / ||g64||)"""
        out = {}
        for name, ref in grads_64.items():
            d = grads[name].cpu().double() - ref
            out[name] = ((d.abs().max() / ref.abs().max().clamp(min=1e-30))
                         .item(), (d.norm() / ref.norm().clamp(min=1e-30))
                         .item())
        return out

    err_d, err_c = errors(grads_d), errors(grads_c)
    for label, err in (("card", err_d), ("CPU fp32", err_c)):
        worst_max = max(err, key=lambda n: err[n][0])
        worst_l2 = max(err, key=lambda n: err[n][1])
        log(f"train reference: {label} gradients against float64 over "
            f"{len(err)} tensors: worst max-norm {worst_max} at "
            f"{err[worst_max][0]:.3e} of its largest magnitude, worst L2 "
            f"{worst_l2} at {err[worst_l2][1]:.3e}")
    name = max(err_d, key=lambda n: err_d[n][1])
    check(err_d[name][1] <= TRAIN_GRAD_L2_TOL,
          f"gradient {name}: card vs float64 L2 {err_d[name][1]} > "
          f"{TRAIN_GRAD_L2_TOL}")


def phase_train(cfg, parts, batch, device):
    """The slice: the car.fhd train step at full width on the card,
    ``TRAIN_STEPS`` steps on one repeated batch. Returns the kernel
    launches made by those steps."""
    net, spec = parts["net"], parts["spec"]
    train_reference(cfg, parts, batch, device)
    opt, lr_fn, mom_fn = opt_builder.build(
        cfg.train_config.optimizer, cfg.train_config.steps,
        list(net.parameters()))
    step = make_train_step(net, spec, opt, lr_fn, mom_fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex = example_to_device(batch, device)
    torch.cuda.synchronize()
    log(f"train batch: H2D {(time.perf_counter() - t0) * 1e3:.3f} ms, "
        f"{sum(v.numel() * v.element_size() for v in ex.values()) / 2**20:.1f}"
        f" MiB")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(ex)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        losses.append(m["loss"].item())
        log(f"train step {i}: device {ms:.3f} ms, loss {losses[-1]:.6f} "
            f"(cls {m['cls_loss'].item():.6f}, loc {m['loc_loss'].item():.6f}, "
            f"dir {m['dir_loss'].item():.6f}), lr {m['lr']:.6e}, grad norm "
            f"{m['grad_norm'].item():.3f}, positives {int(m['num_pos'])}")
    launches = read_launches("train")
    log(f"launches in the {TRAIN_STEPS} train steps: {launches}")
    log(f"train: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0],
          f"loss did not fall: step 0 {losses[0]}, last {losses[-1]}")

    # one more step, part by part (CUDA-synchronised)
    parts_ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts_ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    params = opt.params
    timed("h2d", lambda: example_to_device(batch, device))
    plan = {k: v for k, v in ex.items() if k.startswith("plan_")}
    net.train()
    vf = timed("vfe", lambda: net.voxel_feature_extractor(
        ex["voxels"], ex["num_points"], ex["coordinates"]))
    bev = timed("middle", lambda: net.middle_feature_extractor(
        vf, ex["coordinates"], plan))
    raw = timed("rpn", lambda: net.rpn(bev))
    b = ex["voxels"].shape[0]
    preds = {"box_preds": raw["box_preds"].reshape(b, -1, spec.box_code_size),
             "cls_preds": raw["cls_preds"].reshape(b, -1, spec.num_class),
             "dir_cls_preds": raw["dir_cls_preds"].reshape(
                 b, -1, spec.num_direction_bins)}
    res = timed("loss", lambda: compute_loss(spec, preds, ex))
    grads = timed("backward", lambda: torch.autograd.grad(
        res["loss"], params))
    timed("optimizer", lambda: opt.step(list(grads), lr_fn(opt.count),
                                        mom_fn(opt.count)))
    log(f"train breakdown (device ms, one step at batch {b}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts_ms.items()))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    phase_build()
    ctx = InferenceContext()
    ctx.build(CONFIG, device=device)
    ctx.init_random(0)
    results = phase_kernels(ctx, device)
    launches = {"inference": phase_slice(ctx)}
    phase_reference(ctx)
    phase_breakdown(ctx)

    cfg = load_pipeline_config(CONFIG)
    parts = build_network(cfg, device)
    init_weights(parts["net"], torch.Generator().manual_seed(0))
    batch = prepare_train_batch(
        build_prep_func(cfg.train_input_reader, parts, training=True))
    results["sparse_conv_weight_grad"], k1_err = phase_backward_kernels(
        parts["net"], batch, device)
    k1 = results["sparse_conv_gather_gemm"]
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_err)
    launches["train"] = phase_train(cfg, parts, batch, device)

    kernels = []
    for name, _, source, replaces in KERNELS:
        by_path = {path: counts[name] for path, counts in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **results[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
