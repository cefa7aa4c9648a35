"""Smoke run of the PyTorch/CUDA port (second_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at the published width of their
configs, with random weights from seed 0: car.fhd inference (points ->
detections) through ``InferenceContext`` and car.fhd training steps at
the train reader's batch 8 through ``train.state.make_train_step``
(``configs/car.fhd.config``), PointPillars inference through
``InferenceContext`` on the flat pillar path and PointPillars training
through ``train.__main__.train`` (``configs/pointpillars/car/
xyres_16.config``), then car.fhd training through ``train`` and
``evaluate`` with the GT-database sampler, car.fhd on the device
route (points shipped; the voxels and every rulebook built on the card)
through ``InferenceContext``, ``train`` and ``evaluate``, and the KITTI
multi-class SECOND (``configs/all.fhd.config``: Car, Cyclist, Pedestrian,
Van) through the same entry points, all three under mixed precision
(bf16, ``enable_mixed_precision``), and the nuScenes multi-head
PointPillars (``configs/nuscenes/all.pp.mhead.config``, 10 classes)
through ``InferenceContext``, ``train`` and ``evaluate`` on a
nuScenes-format fixture tree, and car.fhd fine-tuned from an imported
upstream checkpoint (``utils/checkpoint_import.py``) through ``train``
(``pretrained_path``, ``freeze_include``, ``profile_steps``, the
momentum and RMSProp optimizers, the EMA), ``evaluate``,
``script.py`` and the viewer backend, and car.fhd's data-parallel
training over a ``torch.distributed`` group through ``train`` and
``evaluate`` (``second_tpu_torch/parallel``). Phases 6-9
clear the sampler
for ``make_kitti_scene`` frames, which have no database; the fixture
trees of phases 9 and 10 have one. Phases, each printed as it runs:

  1. the card's name and power limit (nvidia-smi) and the nvcc build of
     the five kernels K1 (sparse conv), K2 (its weight gradient), K3
     (rotated IoU), K4 (greedy NMS), K1-bf16 (K1 in bf16);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (K1 on the rulebooks of a
     ``make_kitti_scene`` frame, K3 at [1000, 5] x [1000, 5], K4 at
     n = 1000, on ``tools.nms_profile.clustered_boxes``): max error,
     kernel ms and plain ms (CUDA events around back-to-back wrapper
     calls), and the kernel's device-only ms (20 calls captured in a
     CUDA graph, replayed between CUDA events); K3's share of pairs that
     survive its far-pair reject (exactly 0.0 on the others) and its
     bound counted from that share, K4's time per candidate step; for
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
     K3 and K4 on the card keep exactly the CPU's boxes (with K3's
     share of surviving pairs on those candidates);
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
     with the plain kernels (loss and every gradient);
  8. PointPillars: 4 requests from ``make_kitti_scene(RandomState(i))``
     (detection counts; host preparation, with its host voxelizer, and
     device inference, CUDA-synchronised; K4's launch counter must rise,
     and K3's where the config rotates its NMS), peak memory; frame 0
     again with the network on the CPU (preds agree, detections
     matched); the flat path's BEV canvas against the module path's
     (``voxelize`` -> the encoder -> ``PointPillarsScatter``) on the
     card; frames 0 and 1 as one batch against each alone; a per-stage
     breakdown (pillarize, PFN, scatter, RPN, predict, and the module
     path's voxelize and encoder); K4 on frame 0's NMS candidates
     against its plain version, timed;
  9. PointPillars training: one step at batch 1 on shipped points
     (compact targets, the device voxelizer) against the CPU (loss) and
     a float64 CPU step (gradients), and the host syncs a batch-2 step
     forces (CUDA's sync debug mode); ``train()`` on the published config
     (its GT-database sampler on) for 10 steps at the reader's batch 2
     on an 8-frame fixture tree (``tools/kitti_fixture.py``, prepared by
     ``create_data kitti_data_prep``) with ``measure_time``: losses finite and
     falling, the checkpoint, the median step ms of steps 2-9, data-fetch
     ms, the final eval's fps through the flat pillar path and K4 into
     the official AP, peak memory; ``train(resume=True)`` for 2 more
     steps from the checkpoint;
 10. car.fhd training with the GT-database sampler: ``create_data
     kitti_data_prep`` on 16 fixture frames at KITTI density (infos,
     reduced clouds, the GT database); a sampled batch from the train
     reader: frame 0's loss on the card against the CPU, and the host
     syncs of a batch-2 step (none allowed); ``train()`` on the published
     config (the sampler at Car: 15, batch 8, [41, 1600, 1408], host
     voxels and rulebooks through the loader) for 8 steps with
     ``measure_time``: losses finite and falling, step and data-fetch
     ms, ``sparse_util_max`` and overflow warnings, the final eval
     (rotated NMS: K3 and K4) into the official AP, peak memory;
     ``train(resume=True)`` for 2 more; ``evaluate()``; K1, K2, K3 and
     K4 launched;
 11. car.fhd on the device route (``fhd_device``): 4 requests from
     ``make_kitti_scene(RandomState(i))`` through
     ``InferenceContext.build(..., device_voxelize=True)`` with phase
     3's weights (shipped points, host preparation and device
     inference); for each frame the card's voxel coords, every
     ``plan_*`` rulebook and the stages' counts exactly the host plan's,
     preds within ``ROUTE_REL_TOL`` of the host route's on the card,
     detections matched, and both routes' H2D bytes; frame 0's
     breakdown (H2D, the voxelizer, the rulebooks of each scale, each
     route to detections, launched and as a CUDA-graph replay); on
     phase 10's tree a sampled batch on the route (frame 0's loss card
     against CPU, the host syncs of a batch-2 step: none allowed),
     ``train(device_voxelize=True)`` 6 + 1 resumed steps at batch 8 with
     the sampler and ``evaluate(device_voxelize=True)`` (K1-K4
     launched), the most points a request shipped and the points
     buffer's overflow warnings; then the other five sparse middles and
     both sparse residual blocks, forward and backward in training mode
     at a [800, 704] grid (z 41 or 81 cells), the two routes bitwise
     equal on the card and the card against the CPU;
 12. all.fhd (``all_fhd``): 4 requests from
     ``make_kitti_scene(RandomState(i))`` on host voxels and 4 on the
     device route (the published single-set NMS: K3 +1, K4 +2 a frame),
     and 4 with ``use_multi_class_nms`` set on every class (K3 +4, K4
     +8 a frame), each with its detections per class and host and
     device ms; frame 0 under multi-class NMS on the CPU: preds agree,
     detections matched class by class, and each class's CPU candidates
     through K3 and K4 on the card keep exactly the CPU's boxes;
     ``create_data`` on a 16-frame fixture tree whose frames hold every
     class, a sampled batch (frame 0's loss card against CPU, the
     positive anchors, the host syncs of a batch-2 step: none allowed),
     ``train()`` 6 steps at the reader's batch 8 with the four sample
     groups and ``evaluate()`` (the four classes' official AP); then
     the zoo modules at small widths, card against CPU and a float64
     CPU run, forward and backward: VFELayer, VoxelFeatureExtractor(V2),
     SimpleVoxelRadius, a GroupNorm RPNV2, RPNNoHead, ResNetRPN,
     bev_box_decode, GHM-C and GHM-R;
 13. mixed precision (``bf16``): K1-bf16 against its plain version on
     phase 2's 10 convs (max error, also in bf16 ulps; two calls bitwise
     equal; wrapper, device-only and plain ms; its bound); then, counted
     as the ``bf16`` path, 4 car.fhd requests in bf16 on host voxels
     and 4 on the device route with phase 3's weights (K1 never, K1-bf16
     always launched), 2 all.fhd requests on the device route and 4
     PointPillars requests, each with host and device ms and its preds
     against the same frame's f32 preds on the card; PointPillars'
     bf16 ``train()`` 6 + 2 resumed steps on phase 9's tree (losses,
     step ms, peak memory, f32 checkpoints) and ``evaluate()``; car.fhd's
     bf16 ``evaluate()`` of phase 10's checkpoint; then a PointPillars
     bf16 step at batch 1 against the CPU's bf16 step and a float64 one,
     the host syncs of a bf16 step (none allowed), and car.fhd's bf16
     ``train()``, which must raise ``NotImplementedError``;
 14. the nuScenes multi-head PointPillars (``nusc_mhead``) at its
     published width (random weights from seed 0, batch norms drawn as
     in phase 13): an 8-frame fixture tree at nuScenes density
     (``tools/nusc_fixture.py``: a key frame and 9 sweeps of 34 720
     points); 4 ``InferenceContext`` requests (host and device ms, the
     points shipped against those in range, the points buffer's
     overflow warnings: none allowed, the detections per class; K4, and
     K3 where the NMS rotates, launched); frame 0: the flat path's
     canvas and preds against the module path's on the card, card
     against CPU (preds, detections matched), the CPU's candidates
     through K4 (K3) on the card keeping exactly the CPU's boxes;
     ``create_groundtruth_database("NuScenesDataset", ...)``; a sampled
     batch (frame 0's loss card against CPU, the host syncs of a
     batch-2 step: none allowed); ``train()`` 6 + 2 resumed steps at
     the reader's batch with its sample groups and ``evaluate()`` (the
     10 classes' kitti-style AP); the device voxelizer with
     ``full_empty_part_with_mean`` against the host voxelizer on frame
     0;
 14b. the nuScenes residual sparse SECOND (``nusc_res8x``,
     ``configs/nuscenes/all.res8x.config``) at its published grid and
     widths (random weights from seed 0, batch norms as in phase 14):
     one request of a ``benchmark/gen/nusc_scenes.py`` frame (a key
     frame and 9 sweeps of 34 720 points) on the voxel route, its K1
     count zeroed just before ``inference``: 21 K1 launches (every
     sparse conv), K3 and K4 launched, no plain gather and no
     ``conv3d``, no warning, the detections per class; then each of the
     request's 6 convs above 64 channels (conv4, its blocks, conv_out)
     on its own features and rulebook, K1 against ``gather_gemm_plain``
     (phase 2's tolerance), two calls bitwise equal, its ms beside its
     bound;
 15. car.fhd fine-tuning (``finetune``) on phase 10's 16-frame tree at
     the published width (batch 8, the sampler on): an upstream
     ``.tckpt`` from ``tools/upstream_fixture.py`` (seed 0) through
     ``utils.checkpoint_import.import_tckpt`` (no missing targets), frame
     0 of ``make_kitti_scene`` from it on the card against the CPU
     (phase 4's limits); run A, ``train()`` 6 steps with the momentum
     optimizer, the one-cycle momentum and ``use_moving_average`` (decay
     0.9) and ``profile_steps=2`` (the trace names K1's and K2's
     kernels), then ``evaluate()`` at batch 1, whose frame 0 matches the
     EMA's weights evaluated alone and not the live ones; run B,
     ``train()`` 4 steps of RMSProp from the imported checkpoint
     (``pretrained_path``) with ``freeze_include`` on the sparse middle:
     every frozen tensor bitwise the imported one, every RPN tensor
     moved, K2 never launched and K1 exactly the forward convs (no input
     gradient); the median step ms of both runs; then
     ``helper_tune_target_assigner`` (one epoch) and
     ``script.eval_multi_threshold`` at (0.3, 0.5) on run A's
     checkpoint (detections not rising with the threshold); last the
     viewer backend on 127.0.0.1 (a free port): ``readinfo``,
     ``build_network`` of run A's checkpoint and ``inference_by_idx`` of
     2 frames, each response equal to ``InferenceContext.inference`` on
     the frame, K3 and K4 launched, the request ms;
 16. data-parallel training (``ddp``, ``second_tpu_torch.parallel``) at
     car.fhd's width, global batch 8: (a) one process's
     ``make_train_step`` on phase 7's 8 frames against 2 gloo ranks
     sharing cuda:0 (``parallel.run_ranks``, ``parallel.dryrun.step_rank``)
     on 4 frames each from the same weights (every ReLU opened, as the
     CPU parity tests draw them): the loss within 1e-5, every gradient
     within 1e-3 in relative L2, the ranks' gradients, parameters and
     running statistics bitwise equal, and the negative control (each
     shard alone, gradients averaged by hand) outside 10x that on most
     batch norms; (b) ``train()`` over the 2 ranks with
     the sampler on phase 10's tree, 4 steps and 1 resumed, then
     ``evaluate()`` over them: one log, one set of checkpoints, the AP
     and detections equal to one process's ``evaluate()`` at a rank's
     batch; (c) one NCCL
     rank: its step bitwise the ungrouped step on phase 7's batch (both
     under ``cudnn.deterministic``), 0 host syncs, ``train()`` 2 steps;
     (d) ``parallel.dryrun.dryrun_multichip(2, full=True)`` on cuda:0
     (PointPillars at its published width). Every step ms beside the
     card's name and power limit; gloo's are two processes sharing one
     card, not a two-card number. The ranks report their launches,
     summed as the ``ddp`` path;
 17. the three learning proofs (``tools/overfit_ap.py``, 1000 steps
     each, TF32 off), last and together as three processes on the card,
     each reporting its APs and launches: PointPillars and car.fhd (bev and
     3d AP >= 55; PointPillars printed beside the JAX package's
     ``OVERFIT_AP.json``) and all.fhd (``--model all``, 24 fixture
     frames of two objects of each class: every class's bev and 3d AP
     at ``overfit_ap.ALL_FLOOR`` (55) or above, IoU 0.7 for Car and Van,
     0.5 for Pedestrian and Cyclist); each proof's wall time and the
     three's together.

Then the script's wall time, one JSON line with the kernels (``ms``
times the wrapper,
``device_ms`` the card alone; K1's times and bounds
are sums over the inference frame's 10 sparse convs, K2's over the
training batch's 10; ``bound_ms`` is the fp32 bound and
``bound_tf32x3_ms`` the 3xTF32 one; K1's ``max_abs_err`` is its largest over phases 2
and 6, and its ``wide`` holds phase 14b's 128-channel convs (summed
like the rest); K4's ``pp_candidates`` holds phase 8's numbers; ``launches`` count
the main paths' runs, phases 3, 7, 8, 9 and 10's train() and evaluate()
runs and phases 11, 12 and 14's requests, train() and evaluate() runs,
phase 14b's request, and phase 15's request, train(), evaluate() and viewer runs, and
phase 16's ranks,
with ``launches_by_path`` splitting them, phase 13's as ``bf16``,
phase 14's as ``nusc_mhead``, phase 14b's as ``nusc_res8x``, phase 15's as ``finetune`` and phase 16's
as ``ddp``;
``proof_launches``
counts the three learning proofs apart), and as the last line
``{"ok": true, "device": {...}}``. TF32 is off for the whole run (the
slices before phase 13 are fp32). K1-bf16's ``bound_ms`` counts bf16
bytes at 3.35 TB/s and its operations at 989 TFLOP/s. Any failed check
raises, which exits non-zero; without a CUDA device the script exits 1
before printing any result.
"""

import copy
import json
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from benchmark.gen import nusc_scenes
from second_tpu_torch import script
from second_tpu_torch.builders import voxel_builder
from second_tpu_torch.builders.dataset_builder import build_prep_func
from second_tpu_torch.builders.route import (
    make_route,
    make_voxelizer_fn,
    points_capacity,
)
from second_tpu_torch.builders.network_builder import build_network
from second_tpu_torch.configs import load_pipeline_config, schema
from second_tpu_torch.configs.textproto import parse as parse_text
from second_tpu_torch.create_data import kitti_data_prep
from second_tpu_torch.core.inference import (
    InferenceContext,
    example_convert,
    example_to_device,
)
from second_tpu_torch.csrc import build
from second_tpu_torch.data import make_kitti_scene, merge_second_batch
from second_tpu_torch.data.kitti_dataset import KittiDataset
from second_tpu_torch.data.gt_database import create_groundtruth_database
from second_tpu_torch.data.nuscenes_dataset import NuScenesDataset
from second_tpu_torch.data.preprocess import pad_points
from second_tpu_torch.kittiviewer import backend as viewer
from second_tpu_torch.models.layers import MaskedBatchNorm
from second_tpu_torch.models.middle import scatter_canvas
from second_tpu_torch.models.registry import (
    get_middle_class,
    get_rpn_class,
    get_vfe_class,
)
from second_tpu_torch.models.sparse_middle import (
    SPARSE_MIDDLE_NAMES,
    build_device_plan,
    build_host_plan,
    plan_scales,
)
from second_tpu_torch.models.sparse_resnet import (
    SparseBasicBlock,
    SparseBottleneck,
)
from second_tpu_torch.native import sparse_plan as native_plan
from second_tpu_torch.models.pp_fast import (
    flat_pfn,
    flat_pfn_bev,
    flat_pillarize,
    pointpillars_infer,
)
from second_tpu_torch.models.voxelnet import compute_loss, init_weights, predict
from second_tpu_torch.ops import (
    box_ops_torch,
    cuda_iou,
    cuda_nms,
    cuda_sparse_conv,
    cuda_sparse_conv_bf16,
    cuda_sparse_conv_dw,
    losses,
)
from second_tpu_torch.ops import launch_counts
from second_tpu_torch.ops import sparse as sparse_ops
from second_tpu_torch.ops.nms import candidate_iou
from second_tpu_torch.ops.sparse import (
    SparseConvFunction,
    SparseGrid,
    _kernel_offsets,
    build_subm_rulebook,
    from_voxel_coords,
    transpose_rulebook,
)
from second_tpu_torch.ops.voxelize import voxelize
from second_tpu_torch.parallel import dryrun, mesh
from second_tpu_torch.tools import overfit_ap
from second_tpu_torch.tools.kitti_fixture import build_kitti_dir
from second_tpu_torch.tools.nms_profile import clustered_boxes
from second_tpu_torch.tools.nusc_fixture import build_nusc_dir
from second_tpu_torch.tools.upstream_fixture import write_tckpt
from second_tpu_torch.train import checkpoint as ckpt_lib
from second_tpu_torch.train import optimizer as opt_builder
from second_tpu_torch.train.__main__ import (
    evaluate,
    helper_tune_target_assigner,
    train,
)
from second_tpu_torch.train.state import forward_loss, make_train_step
from second_tpu_torch.utils.checkpoint_import import import_tckpt

# the rows a KITTI frame's point buffer holds (the dataset's capacity)
POINTS_BUFFER = KittiDataset.PointsCapacity
CONFIG = "configs/car.fhd.config"
PP_CONFIG = "configs/pointpillars/car/xyres_16.config"
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
# PointPillars: the flat path's BEV canvas against the module path's on
# the card (allclose): batch norm's affine form, and per-pillar sums that
# add with atomics; batch 2 against the two frames alone: the RPN's preds
# (max |diff| over max |value|; cuDNN may pick other algorithms for
# another batch), then detections matched as card against CPU
PP_CANVAS_TOL = 2e-4
PP_BATCH_REL_TOL = 1e-5
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_GRAD_L2_TOL = 2e-2
TRAIN_BATCH = 8
TRAIN_STEPS = 10
# PointPillars training through train(): steps, then a resume for more,
# on a fixture tree of PP_FRAMES frames; the learning proof's steps and
# its floor on bev and 3d AP (tests/test_overfit_ap.py), and the JAX
# tool's own targets (printed)
PP_TRAIN_STEPS = 10
PP_RESUME_STEPS = 2
PP_FRAMES = 8
PROOF_STEPS = 1000
PROOF_FLOOR = 55.0
PROOF_TARGETS = {"3d": 85.0, "aos": 80.0}
# car.fhd training through train() with its GT-database sampler (phase
# 10): a fixture tree of FHD_FRAMES frames at KITTI density (the scene
# of tools/bench_train_e2e.py), steps at the reader's batch 8, a resume
# for more, and car.fhd's learning proof
FHD_FRAMES = 16
FHD_SCENE = dict(num_cars=10, num_bg_points=16000, points_per_object=250)
FHD_TRAIN_STEPS = 8
FHD_RESUME_STEPS = 2
FHD_PROOF_STEPS = 1000
# car.fhd on the device route (phase 11): train() steps and resumed
# steps on phase 10's tree; the other middles' and the residual blocks'
# voxel capacity; preds of the device route against the host route on
# the card (max |diff| over max |value|): the same voxels in the same
# order, the same rulebooks and kernels
FHD_DEVICE_STEPS = 6
FHD_DEVICE_RESUME = 1
MODULE_VOXELS = 20000
ROUTE_REL_TOL = 1e-5

# all.fhd, the KITTI multi-class SECOND (phase 12): a fixture tree of
# ALL_FRAMES frames at KITTI density with every class in each frame,
# train() steps at the reader's batch; the zoo modules' tolerances at
# their small widths: outputs card against CPU in max |diff| over max
# |value| (cuDNN and CPU convs sum in other orders), input gradients
# against a float64 CPU run in L2 (the RPNs' conv stacks take
# TRAIN_GRAD_L2_TOL: a ReLU input within rounding of zero takes its
# gate either way in two fp32 programs)
ALL_CONFIG = "configs/all.fhd.config"
ALL_FRAMES = 16
ALL_SCENE = dict(classes={"Car": 6, "Pedestrian": 2, "Cyclist": 1, "Van": 1},
                 num_bg_points=16000, points_per_object=250)
ALL_TRAIN_STEPS = 6
ZOO_REL_TOL = 1e-4
# all.fhd's learning proof (tools/overfit_ap.py --model all): each
# class's bev and 3d AP at overfit_ap.ALL_FLOOR (55, the floor of the
# other two proofs) or above
ALL_PROOF_STEPS = 1000
# the three learning proofs run last, together, each in its own process
# (python -m second_tpu_torch.tools.overfit_ap): (name, --model, steps)
PROOFS = (("pp_proof", "pp", PROOF_STEPS), ("fhd_proof", "fhd",
                                            FHD_PROOF_STEPS),
          ("all_proof", "all", ALL_PROOF_STEPS))
PROOF_TIMEOUT = 600
# the nuScenes multi-head PointPillars (phase 14): a fixture tree of
# NUSC_FRAMES frames at nuScenes density (tools/nusc_fixture.py: a key
# frame and 9 sweeps of 34 720 points, boxes of all 10 classes), 4
# requests, train() 6 + 2 resumed steps at the reader's batch with its
# sample groups, evaluate()
MHEAD_CONFIG = "configs/nuscenes/all.pp.mhead.config"
NUSC_FRAMES = 8
NUSC_TRAIN_STEPS = 6
NUSC_RESUME_STEPS = 2
# the nuScenes residual sparse SECOND (phase 14b): one request of a
# generator frame (a key frame and 9 sweeps of 34 720 points, 5 objects
# of each class) runs each of the middle's 21 sparse convs as one K1
# launch (conv_input, 8 residual blocks of 2, 4 strided), 6 of them on
# K1's 128-wide instantiations (conv4 64 -> 128, its blocks, conv_out)
RES8X_CONFIG = "configs/nuscenes/all.res8x.config"
RES8X_SPARSE_CONVS = 21
RES8X_WIDE_CONVS = 6
ZOO_GRAD_L2_TOL = 1e-4

# mixed precision (phase 13): each model's bf16 preds against its f32
# preds of the same frames on the card, max |diff| over the largest f32
# value (twice the JAX package's own bf16 error on a small car.fhd,
# tests/test_torch_bf16.py), with batch norms away from identity as the
# CPU tests draw them; K1-bf16 against its plain version within one
# bf16 ulp (2^-7 of the value: both round an f32 sum once, summed in
# another order) plus 1e-5 of the largest magnitude; a batch-1
# PointPillars bf16 step: its loss against the CPU's bf16 step
# (relative), each gradient against a float64 CPU step in L2 within
# BF16_GRAD_L2_TOL or twice the CPU bf16 step's own distance (bf16
# resolves a nearly cancelling gradient no finer, on any device)
BF16_PREDS_TOL = 1.5e-2
BF16_ULP = 2.0 ** -7
BF16_LOSS_REL_TOL = 1e-2
BF16_GRAD_L2_TOL = 5e-2
BF16_ALL_FRAMES = 2
PP_BF16_STEPS = 6
PP_BF16_RESUME = 2

# phase 15 (finetune): run A's and run B's train() steps, the optimizers
# (the published car.fhd schedule), run A's EMA decay (0.9, so 6 steps
# part it from the live weights), the eval thresholds of
# script.eval_multi_threshold and the viewer's frames
FT_STEPS_A = 6
FT_STEPS_B = 4
FT_PROFILE_STEPS = 2
FT_SCHEDULE = ("learning_rate: { one_cycle: { lr_max: 2.25e-3 "
               "moms: [0.95, 0.85] div_factor: 10.0 pct_start: 0.4 } } "
               "weight_decay: 0.01")
FT_OPTIMIZER_A = ("momentum_optimizer: { %s } use_moving_average: true "
                  "moving_average_decay: 0.9" % FT_SCHEDULE)
FT_OPTIMIZER_B = "rms_prop_optimizer: { %s }" % FT_SCHEDULE
FT_FREEZE = "middle_feature_extractor.*"
FT_THRESHOLDS = (0.3, 0.5)
FT_VIEWER_FRAMES = 2
# data-parallel training (phase 16) at car.fhd's width and global batch
# TRAIN_BATCH: DDP_RANKS gloo ranks sharing cuda:0 (NCCL refuses two
# ranks on one device), then one NCCL rank. The sharded step against
# one process on the same 8 frames: the loss within DDP_LOSS_REL_TOL
# (fp32 sums in another order), every gradient within DDP_GRAD_REL_TOL
# in relative L2, on weights whose ReLUs are opened (_open_relus: at
# identity-initialised norms a ReLU input within rounding of zero takes
# its gate either way in two fp32 programs, which moved the batch
# norms' gradients by up to 1.9e-1 between one process and the ranks),
# a batch norm's bias measured against its scale's gradient
# (_grad_errors); the unsynced control must miss it 10-fold on most
# norms. The
# sharded evaluate()'s detections against one process's at a rank's
# batch within DDP_DETS_TOL, the JAX dry run's limit
DDP_RANKS = 2
DDP_TRAIN_STEPS = 4
DDP_RESUME_STEPS = 1
DDP_NCCL_STEPS = 2
DDP_LOSS_REL_TOL = 1e-5
DDP_GRAD_REL_TOL = 1e-3
DDP_DETS_TOL = 1e-3
DDP_TIMEOUT = 900
# K1's and K2's kernels by name in a torch.profiler trace
K1_TRACE_NAME = "sparse_conv_kernel"
K2_TRACE_NAME = "sparse_conv_dw_partial"

# the card's published peaks (H100 SXM at 700 W): fp32 outside the
# tensor cores, TF32 and bf16 on them and HBM bandwidth, for each
# kernel's least time
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# K1 and K2 run each fp32 product as three TF32 products (3xTF32)
TF32_PASSES = 3
# rows of a K1 tile (TM, csrc/sparse_conv.cu) and of a K2 tile (TR,
# csrc/sparse_conv_dw.cu)
TILE_ROWS = 64
# K3's arithmetic per box pair that runs the clipping (csrc/rotated_iou.cu's
# header), and per pair its far-pair reject takes: 2 subtractions, an
# add and a multiply for the reach, 3 operations for the squared
# distance, a square, a compare and 2 ands
K3_OPS_PER_PAIR = 400
K3_REJECT_OPS_PER_PAIR = 10
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
    # K1-bf16: the bf16 instantiation of the same Pallas kernel
    ("sparse_conv_gather_gemm_bf16", cuda_sparse_conv_bf16,
     "second_tpu_torch/csrc/sparse_conv_bf16.cu",
     "second_tpu/ops/banded_sparse.py:295"),
]
# the kernels each main path must launch
PATH_KERNELS = {
    "inference": ("sparse_conv_gather_gemm", "rotated_iou", "greedy_nms"),
    "train": ("sparse_conv_gather_gemm", "sparse_conv_weight_grad"),
    # and rotated_iou where the config rotates its NMS (xyres_16 does not)
    "pp_inference": ("greedy_nms",),
    # train()'s evals (the flat pillar path)
    "pp_train": ("greedy_nms",),
    # car.fhd's train() steps (K1, K2), its evals and evaluate() (K3, K4)
    "fhd_train": ("sparse_conv_gather_gemm", "sparse_conv_weight_grad",
                  "rotated_iou", "greedy_nms"),
    # phase 11: car.fhd's requests, train() steps and evals on the device
    # route
    "fhd_device": ("sparse_conv_gather_gemm", "sparse_conv_weight_grad",
                   "rotated_iou", "greedy_nms"),
    # phase 12: all.fhd's requests on both routes and with multi-class
    # NMS, its train() steps and evals and evaluate()
    "all_fhd": ("sparse_conv_gather_gemm", "sparse_conv_weight_grad",
                "rotated_iou", "greedy_nms"),
    # phase 13: the bf16 requests of car.fhd (both routes), all.fhd and
    # PointPillars, PointPillars' bf16 train() and evaluate(), car.fhd's
    # bf16 evaluate()
    "bf16": ("sparse_conv_gather_gemm_bf16", "rotated_iou", "greedy_nms"),
    # phase 14: the nuScenes mhead's requests, train() evals and
    # evaluate() (standup NMS: K4; K3 where a config rotates it)
    "nusc_mhead": ("greedy_nms",),
    # phase 14b: one request of the nuScenes residual network (rotated
    # NMS), its 128-channel convs on K1's wide instantiations
    "nusc_res8x": ("sparse_conv_gather_gemm", "rotated_iou", "greedy_nms"),
    # phase 15: the imported checkpoint's request, run A's train() steps
    # and evals, run B's frozen steps (K2 never), the tools' evals and the
    # viewer's requests
    "finetune": ("sparse_conv_gather_gemm", "sparse_conv_weight_grad",
                 "rotated_iou", "greedy_nms"),
    # phase 16: the ranks' sharded steps, train() runs and evals,
    # evaluate() and the dry run (PointPillars: K4), summed over the ranks
    "ddp": ("sparse_conv_gather_gemm", "sparse_conv_weight_grad",
            "rotated_iou", "greedy_nms"),
}
# the learning proofs (tools/overfit_ap.py), counted apart from the
# main paths
PROOF_KERNELS = {
    "pp_proof": PATH_KERNELS["pp_train"],
    "fhd_proof": PATH_KERNELS["fhd_train"],
    "all_proof": PATH_KERNELS["all_fhd"],
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


def bf16_bound_ms(nbytes, ops):
    """The least time (ms) of work that moves ``nbytes`` and does ``ops``
    bf16 tensor-core operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / PEAK_BF16_FLOPS
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


def gather_conv_bound(b, vin, cin, slots, cout, weight_grad, elem=4):
    """Bytes and operations of one sparse conv (K1) or its weight
    gradient (K2) on these rulebooks: each input read once, each output
    written once, 2*Cin*Cout operations per hit (slot < Vin); features,
    weights and outputs of ``elem`` bytes (2 in bf16), slots of 4."""
    _, vout, k = slots.shape
    hits = int((slots < vin).sum().item())
    if weight_grad:  # feat, slots, dout in; dW out
        nbytes = 4 * (b * vin * cin + b * vout * k + b * vout * cout
                      + k * cin * cout)
    else:  # feat, slots, W in; out
        nbytes = (elem * (b * vin * cin + k * cin * cout + b * vout * cout)
                  + 4 * b * vout * k)
    return nbytes, 2 * hits * cin * cout


def conv_rows(example):
    """Input rows of each rulebook: scale i's capacity."""
    rows = {"plan_subm0": example["voxels"].shape[1]}
    for i in range(3):
        rows[f"plan_conv{i}"] = rows[f"plan_subm{i}"]
        if i < 2:
            rows[f"plan_subm{i + 1}"] = example[f"plan_conv{i}"].shape[1]
    return rows


def planned_example(ctx, points):
    """A request of ``points`` as the evaluation loader ships it: the
    host voxels sorted by linear id with the C++ planner's ``plan_*``
    rulebooks and stage counts (``ctx``'s own requests ship no plan:
    their rulebooks are built on the card)."""
    prep = build_prep_func(ctx.config.eval_input_reader, ctx.parts,
                           training=False)
    return merge_second_batch([prep(input_dict={
        "lidar": {"type": "lidar", "points": points},
        "metadata": {"image_idx": 0}})])


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


def graph_ms(fn, iters=20, replays=5):
    """Device-only ms of one call of ``fn``: ``iters`` calls captured in
    a CUDA graph, replayed ``replays`` times between CUDA events, so no
    host work of the wrapper lies inside the timing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


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
    example = planned_example(
        ctx, make_kitti_scene(np.random.RandomState(100))[0])
    net = ctx.parts["net"]
    mid = net.middle_feature_extractor
    g = torch.Generator().manual_seed(0)
    errs, k_ms, d_ms, p_ms, b_ms, t_ms = [], 0.0, 0.0, 0.0, {}, 0.0
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
        dms = graph_ms(lambda: cuda_sparse_conv.gather_gemm(feat, slots, w))
        pms = cuda_ms(
            lambda: cuda_sparse_conv.gather_gemm_plain(feat, slots, w))
        errs.append(err)
        k_ms += kms
        d_ms += dms
        p_ms += pms
        log(f"K1 {wname}: rows {tuple(feat.shape[1:])} -> "
            f"{tuple(slots.shape[1:])} x {cout}, max err {err:.3e}, "
            f"two calls bitwise equal, kernel {kms:.4f} ms (device "
            f"{dms:.4f}), plain "
            f"{pms:.4f} ms, bound fp32 {cms:.4f} ms ({cby}) / 3xTF32 "
            f"{tms:.4f} ms; {co / 1e9:.3f} GFLOP of hits at "
            f"{co / kms / 1e9:.3f} TFLOP/s, {cb / 1e6:.1f} MB; "
            f"{skips(tile_stats(slots, in_rows[pname]))}")
    results["sparse_conv_gather_gemm"] = {
        "max_abs_err": max(errs), "ms": k_ms, "device_ms": d_ms,
        "plain_ms": p_ms, "bound_ms": sum(b_ms.values()),
        "bound_by": max(b_ms, key=b_ms.get), "bound_tf32x3_ms": t_ms,
        "library_ms": None}
    log(f"K1 frame total (10 convs): kernel {k_ms:.4f} ms (device "
        f"{d_ms:.4f}), "
        f"plain {p_ms:.4f} ms, bound fp32 {sum(b_ms.values()):.4f} ms / "
        f"3xTF32 {t_ms:.4f} ms")

    boxes, valid, _ = clustered_boxes(device)
    iou = cuda_iou.rotated_iou_matrix(boxes, boxes)
    ref = cuda_iou.rotated_iou_matrix_plain(boxes, boxes)
    err = (iou - ref).abs().max().item()
    check(err <= K3_TOL, f"K3: max err {err} > {K3_TOL}")
    far = cuda_iou.far_pairs(boxes, boxes)
    check(torch.equal(iou[far], torch.zeros_like(iou[far])),
          "K3: a rejected pair is not exactly 0.0")
    check(torch.equal(iou, cuda_iou.rotated_iou_matrix(boxes, boxes)),
          "K3: two calls differ")
    kms = cuda_ms(lambda: cuda_iou.rotated_iou_matrix(boxes, boxes))
    dms = graph_ms(lambda: cuda_iou.rotated_iou_matrix(boxes, boxes))
    pms = cuda_ms(lambda: cuda_iou.rotated_iou_matrix_plain(boxes, boxes))
    n = boxes.shape[0]
    rejected = int(far.sum())
    k3_bytes = 4 * (2 * n * 5 + n * n)
    k3_bound, k3_by = bound_ms(
        k3_bytes, K3_REJECT_OPS_PER_PAIR * rejected
        + K3_OPS_PER_PAIR * (n * n - rejected))
    k3_every, _ = bound_ms(k3_bytes, K3_OPS_PER_PAIR * n * n)
    results["rotated_iou"] = {
        "max_abs_err": err, "ms": kms, "device_ms": dms, "plain_ms": pms,
        "bound_ms": k3_bound, "bound_by": k3_by,
        "bound_every_pair_clipped_ms": k3_every, "library_ms": None}
    log(f"K3 [1000,5]x[1000,5]: max err {err:.3e}, rejected pairs exactly "
        f"0.0, two calls bitwise equal, kernel {kms:.4f} ms (device "
        f"{dms:.4f}), plain {pms:.4f} ms, pairs overlapping "
        f"{(ref > 0).float().mean().item():.4f}, pairs surviving the "
        f"reject {1 - rejected / (n * n):.4f}; bound {k3_bound:.5f} ms "
        f"({k3_by}) for this run's survivors, {k3_every:.5f} ms had every "
        f"pair been clipped")

    keep = cuda_nms.greedy_suppress(ref, valid, 0.01)
    keep_ref = cuda_nms.greedy_suppress_plain(ref, valid, 0.01)
    mismatches = int((keep != keep_ref).sum().item())
    check(mismatches == 0, f"K4: {mismatches} keep flags differ")
    check(torch.equal(keep, cuda_nms.greedy_suppress(ref, valid, 0.01)),
          "K4: two calls differ")
    kms = cuda_ms(lambda: cuda_nms.greedy_suppress(ref, valid, 0.01))
    dms = graph_ms(lambda: cuda_nms.greedy_suppress(ref, valid, 0.01))
    pms = cuda_ms(lambda: cuda_nms.greedy_suppress_plain(ref, valid, 0.01),
                  iters=3, warmup=1)
    k4_bound, k4_by = bound_ms(4 * n * n + 2 * n,
                               K4_OPS_PER_PAIR * n * (n - 1) // 2)
    results["greedy_nms"] = {
        "max_abs_err": 0.0, "ms": kms, "device_ms": dms, "plain_ms": pms,
        "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None}
    # n dependent decisions: the bound of the bytes is out of reach of a
    # chain whose every step waits for the last
    log(f"K4 n=1000: keep mismatches 0 (kept {int(keep.sum())}), two "
        f"calls bitwise equal, kernel {kms:.4f} ms (device {dms:.4f}: "
        f"{dms / n * 1e6:.2f} ns per candidate step of the chain), plain "
        f"{pms:.4f} ms, bound {k4_bound:.5f} ms ({k4_by}; "
        f"{k4_bound / n * 1e6:.3f} ns per step)")
    return results


def reset_launches():
    for _, module, _, _ in KERNELS:
        module.launches = 0


def read_launches(path):
    """The launch counts since :func:`reset_launches`; each kernel of
    ``path`` must have launched."""
    launches = {name: module.launches for name, module, _, _ in KERNELS}
    for name in {**PATH_KERNELS, **PROOF_KERNELS}[path]:
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
        log(f"frame {i}: {len(points)} points, "
            f"{int(example['num_voxels'][0, 0])} voxels, "
            f"{len(boxes)} detections, host prep "
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


def _nms_steps(spec, preds, anchors, device, ci=None):
    """predict's steps for frame 0 of ``preds`` on ``device``, up to the
    keep mask: over every anchor with its best class's score (car.fhd:
    one class, background encoded as zeros), or with ``ci`` over class
    ``ci``'s anchors and scores under its own settings (multi-class
    NMS); the candidates' IoU rotated (K3) or standup, as the config's
    NMS takes it."""
    box = spec.decode(preds["box_preds"][0].to(device), anchors[0].to(device))
    probs = torch.sigmoid(preds["cls_preds"][0].to(device))
    if ci is None:
        scores, c = probs.max(-1).values, 0
    else:
        s, e = spec.anchors_ranges[ci]
        box, scores, c = box[s:e], probs[s:e, ci], ci
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    k = spec.nms_pre_max_sizes[c]
    top_s, top_i = top_s[:k], top_i[:k]
    cand = box[top_i][:, [0, 1, 3, 4, 6]].contiguous()
    iou = candidate_iou(cand, spec.use_rotate_nms)
    valid = top_s >= spec.nms_score_thresholds[c]
    keep = cuda_nms.greedy_suppress(iou, valid, spec.nms_iou_thresholds[c])
    return {"box": box.cpu(), "scores": scores.cpu(), "top_s": top_s.cpu(),
            "top": top_i.cpu(), "cand": cand, "iou": iou.cpu(),
            "valid": valid.cpu(), "keep": keep.cpu()}


def _nms_disagreement(spec, preds, anchors, device, ci=None):
    """Where predict on the same preds parts ways between the card and
    the CPU, step by step (class ``ci``'s NMS under multi-class NMS).
    Returns, for the CPU's own candidates run through K3 and K4 on the
    card, the valid pairs whose IoU falls on the other side of the
    threshold and the keep flags that differ."""
    label = "reference" if ci is None else f"reference class {ci}"
    thr = spec.nms_iou_thresholds[0 if ci is None else ci]
    cpu = _nms_steps(spec, preds, anchors, "cpu", ci)
    dev = _nms_steps(spec, preds, anchors, device, ci)
    log(f"{label}: same preds, decoded boxes max |diff| "
        f"{(cpu['box'] - dev['box']).abs().max().item():.3e}, scores "
        f"{(cpu['scores'] - dev['scores']).abs().max().item():.3e}, "
        f"candidate scores {cpu['top_s'][-1].item():.9g}.."
        f"{cpu['top_s'][0].item():.9g}, top-k ranks that differ "
        f"{int((cpu['top'] != dev['top']).sum())} of {len(cpu['top'])}, "
        f"keep flags that differ {int((cpu['keep'] != dev['keep']).sum())}")
    # the same candidates in the same order through K3 (or the standup
    # IoU) and K4 on the card
    cand = cpu["cand"].to(device)
    iou = candidate_iou(cand, spec.use_rotate_nms)
    if spec.use_rotate_nms:
        far = cuda_iou.far_pairs(cand, cand)
        check(torch.equal(iou[far], torch.zeros_like(iou[far])),
              "K3 on frame 0's candidates: a rejected pair is not exactly "
              "0.0")
        log(f"{label}: frame 0's {len(cand)} NMS candidates: pairs "
            f"surviving K3's far-pair reject "
            f"{1 - far.float().mean().item():.4f}")
    keep = cuda_nms.greedy_suppress(iou, cpu["valid"].to(device), thr).cpu()
    iou = iou.cpu()
    both = cpu["valid"][:, None] & cpu["valid"][None, :]
    flip = ((iou > thr) != (cpu["iou"] > thr)) & both
    pairs = (flip & torch.ones_like(flip).triu(1)).nonzero().tolist()
    keep_diff = int((keep != cpu["keep"]).sum())
    iou_diff = (iou - cpu["iou"])[both].abs().max().item() if both.any() else 0.0
    log(f"{label}: the CPU's candidates through "
        f"{'K3' if spec.use_rotate_nms else 'the standup IoU'} and K4 on "
        f"the card: "
        f"IoU max |diff| {iou_diff:.3e}, valid pairs on opposite sides of "
        f"{thr}: {len(pairs)}, keep flags that differ {keep_diff} (kept "
        f"{int(cpu['keep'].sum())} of {int(cpu['valid'].sum())} valid)")
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


def _pp_flat_inputs(ctx, ex):
    """The flat path's pillarizer arguments for frame 0 of ``ex``."""
    gen = ctx.parts["voxel_generator"]
    return (ex["points"][0], ex["points_count"][0, 0],
            tuple(float(x) for x in gen.voxel_size),
            tuple(float(x) for x in gen.point_cloud_range[:3]),
            tuple(int(x) for x in gen.grid_size),
            ctx.config.eval_input_reader.preprocess.max_number_of_voxels,
            int(gen.max_num_points_per_voxel))


def pp_slice(ctx):
    """4 PointPillars requests through the port's entry points; returns
    the kernel launches made during them."""
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
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
        check(boxes.ndim == 2 and boxes.shape[1] == 7 and len(boxes) > 0
              and np.isfinite(boxes).all(), f"pp frame {i}: bad boxes")
        log(f"pp frame {i}: {len(points)} points, "
            f"{int(example['num_voxels'][0, 0])} pillars, "
            f"{int(example['anchors_mask'].sum())} of "
            f"{example['anchors_mask'].size} anchors unmasked, "
            f"{len(boxes)} detections, host prep {(t1 - t0) * 1e3:.3f} ms, "
            f"device inference {(t2 - t1) * 1e3:.3f} ms, total "
            f"{(t2 - t0) * 1e3:.3f} ms")
    launches = read_launches("pp_inference")
    if ctx.parts["spec"].use_rotate_nms:
        check(launches["rotated_iou"] > 0,
              "the pp_inference path never launched rotated_iou")
    log(f"pp: launches in the {N_FRAMES} frames: {launches}")
    log(f"pp: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, of which "
        f"{before / 2**20:.1f} MiB were allocated before the requests "
        f"(both networks' weights and the car.fhd phases' tensors)")
    return launches


def pp_checks(ctx, device):
    """Frame 0 against the network on the CPU; the flat path's canvas
    against the module path's on the card; frames 0 and 1 as one batch
    against each alone."""
    examples = [ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(i))[0]) for i in (0, 1)]
    preds, dets = ctx.run(examples[0])
    cpu = InferenceContext()
    cpu.build(PP_CONFIG, device="cpu")
    cpu.parts["net"].load_state_dict(ctx.parts["net"].state_dict())
    t0 = time.perf_counter()
    preds_cpu, dets_cpu = cpu.run(examples[0])
    log(f"pp reference: frame 0 on the CPU took "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    for key in preds:
        ref = preds_cpu[key]
        rel = ((preds[key].cpu() - ref).abs().max()
               / ref.abs().max().clamp(min=1e-12)).item()
        check(rel <= PREDS_REL_TOL,
              f"pp {key}: card vs CPU rel err {rel} > {PREDS_REL_TOL}")
        log(f"pp reference: {key} {tuple(ref.shape)} card vs CPU rel err "
            f"{rel:.3e}")
    frac, _, _ = _match(_ragged(dets), _ragged(dets_cpu))
    log(f"pp reference: detections card {int(dets['valid'].sum())}, CPU "
        f"{int(dets_cpu['valid'].sum())}, matched {frac:.4f}")
    check(frac >= FRAME_MATCH_MIN,
          f"pp detections matched {frac} < {FRAME_MATCH_MIN}")

    net = ctx.parts["net"]
    ex = example_to_device(examples[0], device)
    pts, n, vs, rmin, grid, max_voxels, t = _pp_flat_inputs(ctx, ex)
    with torch.no_grad():
        flat = flat_pillarize(pts, n, vs, rmin, grid, max_voxels, t)
        bev_flat = flat_pfn_bev(net.voxel_feature_extractor, *flat[:5],
                                max_points_per_voxel=t, grid_size=grid)[None]
        voxels, coords, counts, nv = voxelize(pts, n, vs, rmin, grid,
                                              max_voxels, t)
        bev_mod = net.middle_feature_extractor(
            net.voxel_feature_extractor(voxels[None], counts[None],
                                        coords[None]), coords[None])
    err = (bev_flat - bev_mod).abs().max().item()
    check(int(nv) == int(flat[5]) == int(examples[0]["num_voxels"][0, 0]),
          f"pp: pillars flat {int(flat[5])}, module {int(nv)}, host "
          f"{int(examples[0]['num_voxels'][0, 0])}")
    check(torch.allclose(bev_flat, bev_mod, atol=PP_CANVAS_TOL,
                         rtol=PP_CANVAS_TOL),
          f"pp: flat canvas vs module path max err {err}")
    log(f"pp canvas: flat path vs module path (voxelize -> "
        f"{type(net.voxel_feature_extractor).__name__} -> "
        f"PointPillarsScatter) on the card, {tuple(bev_flat.shape)}, "
        f"{int(nv)} pillars, max err {err:.3e} (max "
        f"{bev_mod.abs().max().item():.3f})")

    batch = {k: np.concatenate([v, examples[1][k]])
             if isinstance(v, np.ndarray) else v + examples[1][k]
             for k, v in examples[0].items()}
    preds_b, dets_b = ctx.run(batch)
    for b, example in enumerate(examples):
        preds_1, dets_1 = ctx.run(example)
        rel = max(((preds_b[k][b] - preds_1[k][0]).abs().max()
                   / preds_1[k][0].abs().max()).item() for k in preds_1)
        frac, _, _ = _match(_ragged({k: v[b:b + 1] for k, v in
                                     dets_b.items()}), _ragged(dets_1))
        log(f"pp batch 2: frame {b} against itself alone: preds rel err "
            f"{rel:.3e}, detections {int(dets_b['valid'][b].sum())} vs "
            f"{int(dets_1['valid'].sum())}, matched {frac:.4f}, bitwise "
            f"equal {all(torch.equal(dets_b[k][b], dets_1[k][0]) for k in dets_1)}")
        check(rel <= PP_BATCH_REL_TOL,
              f"pp batch 2 frame {b}: preds rel err {rel}")
        check(frac >= FRAME_MATCH_MIN,
              f"pp batch 2 frame {b}: detections matched {frac}")
    return examples[0], preds


def pp_breakdown(ctx, example, preds, device):
    """Device ms of each stage of frame 0 (synchronised, mean of 5), the
    module path's stages beside them, and K4 on frame 0's NMS
    candidates against its plain version. Returns K4's numbers."""
    net, spec = ctx.parts["net"], ctx.parts["spec"]
    vfe = net.voxel_feature_extractor
    ex = example_to_device(example, device)
    pts, n, vs, rmin, grid, max_voxels, t = _pp_flat_inputs(ctx, ex)
    with torch.no_grad():
        flat = flat_pillarize(pts, n, vs, rmin, grid, max_voxels, t)
        pooled = flat_pfn(vfe, flat[0], flat[1], flat[2], flat[4], t)
        bev = scatter_canvas(pooled[None], flat[3][None], grid[1], grid[0])
        voxels, coords, counts, _ = voxelize(pts, n, vs, rmin, grid,
                                             max_voxels, t)
        stages = {
            "h2d": lambda: example_to_device(example, device),
            "pillarize": lambda: flat_pillarize(pts, n, vs, rmin, grid,
                                                max_voxels, t),
            "pfn": lambda: flat_pfn(vfe, flat[0], flat[1], flat[2],
                                    flat[4], t),
            "scatter": lambda: scatter_canvas(pooled[None], flat[3][None],
                                              grid[1], grid[0]),
            "rpn": lambda: net.rpn_preds(bev),
            "predict": lambda: predict(spec, preds, ex),
            "module path: voxelize": lambda: voxelize(
                pts, n, vs, rmin, grid, max_voxels, t),
            "module path: encoder": lambda: vfe(
                voxels[None], counts[None], coords[None]),
        }
        parts = {name: cuda_ms(fn, iters=5, warmup=2)
                 for name, fn in stages.items()}
        # the same work without the host's launches in the way: each
        # captured in a CUDA graph (the path has no host sync)
        pillars = graph_ms(lambda: flat_pfn_bev(
            vfe, *flat_pillarize(pts, n, vs, rmin, grid, max_voxels, t)[:5],
            max_points_per_voxel=t, grid_size=grid), iters=5, replays=3)
        whole = graph_ms(lambda: pointpillars_infer(
            net, spec, ex, gen=ctx.parts["voxel_generator"],
            max_voxels=max_voxels), iters=5, replays=3)
    log("pp breakdown (device ms, frame 0): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    log(f"pp breakdown, device-only (CUDA graph): pillarize + pfn + "
        f"scatter {pillars:.3f} ms (launched one by one: "
        f"{parts['pillarize'] + parts['pfn'] + parts['scatter']:.3f}), "
        f"the whole device path (pointpillars_infer: pillars, RPN, "
        f"predict) {whole:.3f} ms")

    # predict's NMS steps for frame 0, up to K4 (one class, background
    # encoded as zeros)
    box = spec.decode(preds["box_preds"][0], ex["anchors"][0])
    scores = torch.sigmoid(preds["cls_preds"][0]).max(-1).values
    scores = torch.where(ex["anchors_mask"][0], scores, -float("inf"))
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    k = spec.nms_pre_max_sizes[0]
    cand = box[top_i[:k]][:, [0, 1, 3, 4, 6]].contiguous()
    iou = candidate_iou(cand, spec.use_rotate_nms)
    valid = top_s[:k] >= spec.nms_score_thresholds[0]
    thr = spec.nms_iou_thresholds[0]
    keep = cuda_nms.greedy_suppress(iou, valid, thr)
    keep_ref = cuda_nms.greedy_suppress_plain(iou, valid, thr)
    mismatches = int((keep != keep_ref).sum())
    check(mismatches == 0, f"K4 on pp frame 0: {mismatches} keep flags differ")
    res = {"n": k, "valid": int(valid.sum()), "kept": int(keep.sum()),
           "ms": cuda_ms(lambda: cuda_nms.greedy_suppress(iou, valid, thr)),
           "device_ms": graph_ms(
               lambda: cuda_nms.greedy_suppress(iou, valid, thr)),
           "plain_ms": cuda_ms(
               lambda: cuda_nms.greedy_suppress_plain(iou, valid, thr),
               iters=3, warmup=1)}
    res["bound_ms"], res["bound_by"] = bound_ms(
        4 * k * k + 2 * k, K4_OPS_PER_PAIR * k * (k - 1) // 2)
    log(f"K4 on pp frame 0's {k} candidates ({res['valid']} over the "
        f"score threshold, {'rotated' if spec.use_rotate_nms else 'standup'}"
        f" IoU): keep mismatches 0 "
        f"(kept {res['kept']}), kernel {res['ms']:.4f} ms (device "
        f"{res['device_ms']:.4f}), plain {res['plain_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.5f} ms ({res['bound_by']})")
    return res


def phase_pp(device):
    """PointPillars inference at the published width of ``PP_CONFIG``
    through the flat pillar path. Returns the launches of its requests
    and K4's numbers on its candidates."""
    ctx = InferenceContext()
    ctx.build(PP_CONFIG, device=device)
    ctx.init_random(0)
    check(ctx.route.flat_pp, "PointPillars must run the flat pillar path")
    gen = ctx.parts["voxel_generator"]
    log(f"pp: {PP_CONFIG}, grid {gen.grid_size.tolist()}, "
        f"{ctx.config.eval_input_reader.preprocess.max_number_of_voxels} "
        f"pillars of T = {gen.max_num_points_per_voxel}, "
        f"{len(ctx.parts['anchor_cache']['anchors'])} anchors, "
        f"{type(ctx.parts['net'].voxel_feature_extractor).__name__}, "
        f"{sum(p.numel() for p in ctx.parts['net'].parameters())} "
        f"parameters, rotated NMS {ctx.parts['spec'].use_rotate_nms}")
    launches = pp_slice(ctx)
    example, preds = pp_checks(ctx, device)
    return launches, pp_breakdown(ctx, example, preds, device)


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
            "k2_device": graph_ms(lambda: cuda_sparse_conv_dw.sparse_conv_dw(
                feat, slots, dout), iters=5, replays=2),
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
            f"kernel {times['k2']:.4f} ms (device {times['k2_device']:.4f}), "
            f"plain {times['k2_plain']:.4f} ms, "
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
        f"(device {sums['k2_device']:.4f}, plain {sums['k2_plain']:.4f}, "
        f"bound fp32 {sums['k2_bound']:.4f} / "
        f"3xTF32 {sums['k2_bound_t']:.4f}), K1 forward "
        f"{sums['k1_fwd']:.4f} ms (plain {sums['k1_fwd_plain']:.4f}, bound "
        f"fp32 {sums['k1_bound']:.4f} / 3xTF32 {sums['k1_bound_t']:.4f}), "
        f"K1 input grad {sums['k1_dgrad']:.4f} ms (plain "
        f"{sums['k1_dgrad_plain']:.4f}, bound fp32 "
        f"{sums['k1_dgrad_bound']:.4f} / 3xTF32 "
        f"{sums['k1_dgrad_bound_t']:.4f})")
    return {"max_abs_err": max(errs), "ms": sums["k2"],
            "device_ms": sums["k2_device"],
            "plain_ms": sums["k2_plain"], "bound_ms": sum(b_ms.values()),
            "bound_by": max(b_ms, key=b_ms.get),
            "bound_tf32x3_ms": sums["k2_bound_t"],
            "library_ms": None}, max(k1_errs)


def loss_and_grads(net, spec, example, route=None):
    """Loss and gradients of one training forward on a copy of ``net``
    (its batch statistics stay as they are)."""
    net = copy.deepcopy(net)
    loss = forward_loss(net, spec, example, route)["loss"]
    names, params = zip(*net.named_parameters())
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, params)))


def train_reference(cfg, parts, batch, device, route=None,
                    label="train"):
    """One step's loss and gradients at batch 1 on the card against the
    same network on the CPU (the plain kernels), in fp32 and float64;
    ``route`` for point-shipping batches."""
    batch1 = {k: v[:1] for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    loss_d, grads_d = loss_and_grads(
        parts["net"], parts["spec"], example_to_device(batch1, device),
        route)
    cpu = build_network(cfg, "cpu")
    cpu["net"].load_state_dict(parts["net"].state_dict())
    ex = example_to_device(batch1, "cpu")
    t0 = time.perf_counter()
    loss_c, grads_c = loss_and_grads(cpu["net"], cpu["spec"], ex, route)
    ex64 = {k: v.double() if v.is_floating_point() else v
            for k, v in ex.items()}
    _, grads_64 = loss_and_grads(cpu["net"].double(), cpu["spec"], ex64,
                                 route)
    log(f"{label} reference: batch 1 on the CPU in fp32 and float64 took "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    rel = abs(loss_d - loss_c) / abs(loss_c)
    log(f"{label} reference: batch 1 loss card {loss_d:.6f}, CPU "
        f"{loss_c:.6f} (rel {rel:.3e})")
    check(rel <= TRAIN_LOSS_REL_TOL,
          f"{label} loss card {loss_d} vs CPU {loss_c}: rel {rel}")

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
    for who, err in (("card", err_d), ("CPU fp32", err_c)):
        worst_max = max(err, key=lambda n: err[n][0])
        worst_l2 = max(err, key=lambda n: err[n][1])
        log(f"{label} reference: {who} gradients against float64 over "
            f"{len(err)} tensors: worst max-norm {worst_max} at "
            f"{err[worst_max][0]:.3e} of its largest magnitude, worst L2 "
            f"{worst_l2} at {err[worst_l2][1]:.3e}")
    name = max(err_d, key=lambda n: err_d[n][1])
    check(err_d[name][1] <= TRAIN_GRAD_L2_TOL,
          f"{label} gradient {name}: card vs float64 L2 {err_d[name][1]} > "
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
    preds = timed("rpn", lambda: net.rpn_preds(bev))
    b = ex["voxels"].shape[0]
    res = timed("loss", lambda: compute_loss(spec, preds, ex))
    grads = timed("backward", lambda: torch.autograd.grad(
        res["loss"], params))
    timed("optimizer", lambda: opt.step(list(grads), lr_fn(opt.count),
                                        mom_fn(opt.count)))
    log(f"train breakdown (device ms, one step at batch {b}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts_ms.items()))
    return launches


def without_sampler(cfg):
    """``cfg`` with its train reader's GT-database sampler cleared: the
    sampler needs a GT database, and the ``make_kitti_scene`` frames of
    phases 6-9 have none (the fixture trees of phases 9 and 10 do)."""
    cfg.train_input_reader.preprocess.database_sampler = (
        schema.Sampler.from_raw({}))
    return cfg


def sync_count(step, ex):
    """Host syncs that one call of the train ``step`` on ``ex`` forces,
    under CUDA's sync debug mode, after a warm-up call (cuDNN picks its
    algorithms); with the first one's message."""
    step(ex)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            step(ex)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in rec
             if "synchroniz" in str(w.message)]
    return len(syncs), (": " + syncs[0] if syncs else "")


def pp_step_reference(device):
    """One PointPillars train step at batch 1 through ``forward_loss`` on
    shipped points (compact targets, the device voxelizer), full width,
    against the CPU (loss) and a float64 CPU step (gradients); then one
    step of ``make_train_step`` under CUDA's sync debug mode, to count
    the host syncs it forces."""
    cfg = without_sampler(load_pipeline_config(PP_CONFIG))
    parts = build_network(cfg, device)
    init_weights(parts["net"], torch.Generator().manual_seed(0))
    route = make_route(parts, cfg.train_input_reader, "train", True)
    prep = build_prep_func(cfg.train_input_reader, parts, training=True,
                           route=route)
    np.random.seed(0)
    batch = merge_second_batch([prep(input_dict=train_input(i))
                                for i in range(2)])
    log(f"pp train batch: {batch['points_count'][:, 0].tolist()} shipped "
        f"points of {POINTS_BUFFER}, positive anchors "
        f"{batch['pos_count'][:, 0].tolist()}")
    train_reference(cfg, parts, batch, device, route, label="pp train")
    opt, lr_fn, mom_fn = opt_builder.build(
        cfg.train_config.optimizer, cfg.train_config.steps,
        list(parts["net"].parameters()))
    step = make_train_step(parts["net"], parts["spec"], opt, lr_fn, mom_fn,
                           route=route)
    n, first = sync_count(step, example_to_device(batch, device))
    log(f"pp train step at batch 2: {n} host syncs under CUDA's sync debug "
        f"mode{first}")


def fixture_tree(work, frames, scene_kwargs=None):
    """A fixture KITTI tree of ``frames`` frames under ``work``, prepared
    by ``create_data kitti_data_prep`` (infos, reduced clouds and the GT
    database); every frame is in the train and the val split."""
    root = work / "kitti"
    t0 = time.perf_counter()
    ids = build_kitti_dir(root, num_frames=frames, seed=0,
                          scene_kwargs=scene_kwargs)
    sets = work / "ImageSets"
    sets.mkdir()
    for split in ("train", "val"):
        (sets / f"{split}.txt").write_text("\n".join(map(str, ids)) + "\n")
    t1 = time.perf_counter()
    kitti_data_prep(str(root), imageset_dir=str(sets))
    db = len(list((root / "gt_database").iterdir()))
    log(f"fixture tree: {frames} frames {scene_kwargs or {}} in "
        f"{t1 - t0:.3f} s; create_data kitti_data_prep (infos, reduced "
        f"clouds, GT database of {db} objects) in "
        f"{time.perf_counter() - t1:.3f} s")
    return root


def fixture_config(config, root, path, steps, mixed_precision=False):
    """The published ``config`` reading the fixture tree at ``root``, its
    GT-database sampler on the tree's database, ``steps`` steps, no
    periodic eval or timed checkpoint within them; in bf16 with
    ``mixed_precision``."""
    cfg = load_pipeline_config(config)
    cfg.train_config.enable_mixed_precision = mixed_precision
    for reader, split in ((cfg.train_input_reader, "train"),
                          (cfg.eval_input_reader, "val")):
        reader.dataset.kitti_root_path = str(root)
        reader.dataset.kitti_info_path = str(
            root / f"kitti_infos_{split}.pkl")
    cfg.train_input_reader.preprocess.database_sampler.database_info_path = (
        str(root / "kitti_dbinfos_train.pkl"))
    cfg.train_config.steps = steps
    cfg.train_config.save_checkpoints_secs = 3600
    path.write_text(cfg.to_text())
    return str(path)


def _log_steps(model_dir):
    """(losses by step, train_step ms by step, data_fetch ms by step,
    eval lines) from a model dir's logs (display_step 1, measure_time)."""
    records = [json.loads(line) for line in
               (model_dir / "log.json.lst").read_text().splitlines()]
    losses = {r["step"]: r["runtime.loss"] for r in records}
    step_ms, fetch_ms = {}, {}
    text = (model_dir / "log.txt").read_text()
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if line.startswith("avg_time_ms: "):
            step = int(lines[i - 1].split(",")[0].split("=")[1])
            times = dict(kv.split("=") for kv in line[13:].split(", "))
            step_ms[step] = float(times["train_step"])
            fetch_ms[step] = float(times["data_fetch"])
    evals = [line for line in lines if line.startswith("eval: ")]
    return losses, step_ms, fetch_ms, evals, text


def phase_pp_train(device, work):
    """Phase 9: PointPillars training through the port's entry points,
    on a fixture tree made under ``work`` (kept for phase 13). Returns
    the kernel launches of its train() runs and the tree's root."""
    pp_step_reference(device)
    work.mkdir()
    root = fixture_tree(work, PP_FRAMES)
    model_dir = work / "model"
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train(fixture_config(PP_CONFIG, root, work / "pp.config",
                         PP_TRAIN_STEPS),
          str(model_dir), display_step=1, measure_time=True,
          device=device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    losses, step_ms, fetch_ms, evals, text = _log_steps(model_dir)
    loss = [losses[i] for i in range(1, PP_TRAIN_STEPS + 1)]
    check(all(np.isfinite(loss)), f"pp train: non-finite loss {loss}")
    check(loss[-1] < loss[0], f"pp train: loss did not fall: {loss}")
    check((model_dir / f"voxelnet-{PP_TRAIN_STEPS}.ckpt").is_file(),
          "pp train: no checkpoint at the last step")
    check("Evaluation official" in text, "pp train: no official eval")
    mid = range(2, PP_TRAIN_STEPS)
    log(f"pp train(): {PP_TRAIN_STEPS} steps at batch 2 with the "
        f"sampler on {PP_FRAMES} fixture frames, wall {wall:.3f} s (with the final "
        f"eval), loss {loss[0]:.6f} -> {loss[-1]:.6f}, step ms "
        f"(CUDA-synchronised) median of steps 2-{PP_TRAIN_STEPS - 1} "
        f"{statistics.median(step_ms[i] for i in mid):.3f} (all: "
        f"{[round(step_ms[i], 3) for i in sorted(step_ms)]}), data-fetch "
        f"ms median {statistics.median(fetch_ms[i] for i in mid):.3f} "
        f"(all: {[round(fetch_ms[i], 3) for i in sorted(fetch_ms)]}), "
        f"{evals[-1]}, peak device memory {peak:.1f} MiB")

    t0 = time.perf_counter()
    train(fixture_config(PP_CONFIG, root, work / "pp_resume.config",
                         PP_TRAIN_STEPS + PP_RESUME_STEPS),
          str(model_dir), resume=True, display_step=1,
          measure_time=True, device=device)
    losses, _, _, evals, text = _log_steps(model_dir)
    check(sorted(losses) == list(range(
        1, PP_TRAIN_STEPS + PP_RESUME_STEPS + 1)),
          f"pp resume: logged steps {sorted(losses)}")
    check((model_dir / f"voxelnet-{PP_TRAIN_STEPS + PP_RESUME_STEPS}"
           ".ckpt").is_file(), "pp resume: no checkpoint")
    check(text.count("Evaluation official") == 2,
          "pp resume: no official eval")
    log(f"pp train(resume=True): restored step {PP_TRAIN_STEPS}, "
        f"steps {PP_TRAIN_STEPS + 1}-{PP_TRAIN_STEPS + PP_RESUME_STEPS} "
        f"losses {[round(losses[i], 6) for i in range(PP_TRAIN_STEPS + 1, PP_TRAIN_STEPS + PP_RESUME_STEPS + 1)]}"
        f", wall {time.perf_counter() - t0:.3f} s, {evals[-1]}")
    official = text[text.rfind("Evaluation official"):].splitlines()[1:6]
    log("pp train: final eval (random start, 12 steps): "
        + " | ".join(official))
    launches = read_launches("pp_train")
    log(f"pp train: launches in the train() runs: {launches}")

    return launches, root


def _loss_of(net, spec, example, route=None):
    """The loss of one training forward of a copy of ``net``."""
    with torch.no_grad():
        return forward_loss(copy.deepcopy(net), spec, example,
                            route)["loss"].item()


def fhd_step_checks(config, root, device, device_route=False, label=None,
                    dataset=None):
    """A sampled car.fhd batch from the train reader: frame 0's loss on
    the card against the CPU, and the host syncs of a batch-2 step. The
    device route ships points and compact targets; the step voxelizes
    and builds the rulebooks on the device (or pillarizes, for a
    PointPillars config). ``dataset``: where the frames come from, by
    default the KITTI tree at ``root``."""
    label = label or ("fhd device route" if device_route else "fhd")
    cfg = load_pipeline_config(config)
    parts = build_network(cfg, device)
    init_weights(parts["net"], torch.Generator().manual_seed(0))
    np.random.seed(0)
    route = make_route(parts, cfg.train_input_reader, "train", device_route)
    capacity = route.points_capacity
    prep = build_prep_func(cfg.train_input_reader, parts, training=True,
                           route=route)
    dataset = dataset or KittiDataset(root_path=str(root), info_path=str(
        root / "kitti_infos_train.pkl"))
    inputs = [dataset.get_sensor_data(i) for i in range(2)]
    own = [len(d["lidar"]["annotations"]["names"]) for d in inputs]
    t0 = time.perf_counter()
    frames = [prep(input_dict=d) for d in inputs]
    ms = (time.perf_counter() - t0) * 1e3 / 2
    batch = merge_second_batch(frames)
    shipped = (f"points shipped {batch['points_count'][:, 0].tolist()} of "
               f"{capacity}" if device_route else
               f"active per stage {batch['sparse_active_counts'].tolist()}")
    positives = (batch["pos_count"][:, 0] if device_route
                 else (batch["labels"] > 0).sum(1)).tolist()
    # a points batch without an anchor mask has no host voxels to count
    voxels = (f"voxels {batch['num_voxels'][:, 0].tolist()}, "
              if "num_voxels" in batch else "")
    log(f"{label} sampled batch: {[len(f['gt_names']) for f in frames]} "
        f"boxes after sampling (the frames' own {own}), positive anchors "
        f"{positives}, host preparation {ms:.3f} ms per frame, {voxels}"
        f"{shipped}")
    batch1 = {k: v[:1] for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    loss_d = _loss_of(parts["net"], parts["spec"],
                      example_to_device(batch1, device), route)
    cpu = build_network(cfg, "cpu")
    cpu["net"].load_state_dict(parts["net"].state_dict())
    loss_c = _loss_of(cpu["net"], cpu["spec"],
                      example_to_device(batch1, "cpu"), route)
    rel = abs(loss_d - loss_c) / abs(loss_c)
    log(f"{label} sampled batch 1: loss card {loss_d:.6f}, CPU "
        f"{loss_c:.6f} (rel {rel:.3e})")
    check(rel <= TRAIN_LOSS_REL_TOL,
          f"{label} sampled loss card {loss_d} vs CPU {loss_c}: rel {rel}")
    opt, lr_fn, mom_fn = opt_builder.build(
        cfg.train_config.optimizer, cfg.train_config.steps,
        list(parts["net"].parameters()))
    step = make_train_step(parts["net"], parts["spec"], opt, lr_fn, mom_fn,
                           route=route)
    n, first = sync_count(step, example_to_device(batch, device))
    log(f"{label} train step at batch 2: {n} host syncs under CUDA's sync "
        f"debug mode{first}")
    check(n == 0, f"{label} train step: {n} host syncs{first}")


def fhd_train_runs(config, root, work, device, label, steps, resume_steps,
                   device_voxelize="auto", base_config=CONFIG,
                   frames=FHD_FRAMES, mixed_precision=False,
                   resume_config=None, metric="official"):
    """A config (car.fhd, all.fhd, the nuScenes mhead, or PointPillars
    in bf16: ``base_config`` read as ``config``) through ``train``
    (``steps`` steps with ``measure_time``), ``train(resume=True)`` for
    ``resume_steps`` more (none when 0; on ``resume_config``, by default
    ``fixture_config`` of ``base_config``), then ``evaluate``, on the
    fixture tree of ``frames`` frames at ``root``, each run ending in the
    dataset's eval, ``metric`` (KITTI's "official", nuScenes'
    kitti-style "kitti.official"; K3 where NMS rotates, K4). Returns the
    kernel launches of those runs."""
    batch = load_pipeline_config(config).train_input_reader.batch_size
    model_dir = work / f"model_{label}"
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    np.random.seed(0)
    t0 = time.perf_counter()
    train(config, str(model_dir), display_step=1, measure_time=True,
          device_voxelize=device_voxelize, device=device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    losses, step_ms, fetch_ms, evals, text = _log_steps(model_dir)
    records = [json.loads(line) for line in
               (model_dir / "log.json.lst").read_text().splitlines()]
    util = [r["runtime.sparse_util_max"] for r in records
            if "runtime.sparse_util_max" in r]
    loss = [losses[i] for i in range(1, steps + 1)]
    check(all(np.isfinite(loss)), f"{label} train: non-finite loss {loss}")
    check(loss[-1] < loss[0], f"{label} train: loss did not fall: {loss}")
    check((model_dir / f"voxelnet-{steps}.ckpt").is_file(),
          f"{label} train: no checkpoint at the last step")
    check(f"Evaluation {metric}" in text, f"{label} train: no {metric} eval")
    mid = range(2, steps)
    log(f"{label} train(): {steps} steps at batch {batch} with the "
        f"sampler on {frames} fixture frames, device_voxelize="
        f"{device_voxelize}, wall {wall:.3f} s "
        f"(with the final eval), loss {loss[0]:.6f} -> {loss[-1]:.6f} "
        f"(all: {[round(v, 6) for v in loss]}), step ms "
        f"(CUDA-synchronised) median of steps 2-{steps - 1} "
        f"{statistics.median(step_ms[i] for i in mid):.3f} (all: "
        f"{[round(step_ms[i], 3) for i in sorted(step_ms)]}), data-fetch "
        f"ms median {statistics.median(fetch_ms[i] for i in mid):.3f} "
        f"(all: {[round(fetch_ms[i], 3) for i in sorted(fetch_ms)]}), "
        f"sparse_util_max {[round(u, 4) for u in util]} (overflow "
        f"warnings: {text.count('OVERFLOW')}), {evals[-1]}, peak device "
        f"memory {peak:.1f} MiB")

    total = steps + resume_steps
    if resume_steps:
        t0 = time.perf_counter()
        train(resume_config or fixture_config(
                  base_config, root, work / f"{label}_resume.config", total,
                  mixed_precision),
              str(model_dir), resume=True, display_step=1,
              measure_time=True, device_voxelize=device_voxelize,
              device=device)
        losses, _, _, evals, text = _log_steps(model_dir)
        check(sorted(losses) == list(range(1, total + 1)),
              f"{label} resume: logged steps {sorted(losses)}")
        check((model_dir / f"voxelnet-{total}.ckpt").is_file(),
              f"{label} resume: no checkpoint")
        check(text.count(f"Evaluation {metric}") == 2,
              f"{label} resume: no {metric} eval")
        log(f"{label} train(resume=True): restored step {steps}, "
            f"steps {steps + 1}-{total} losses "
            f"{[round(losses[i], 6) for i in range(steps + 1, total + 1)]}"
            f", wall {time.perf_counter() - t0:.3f} s, {evals[-1]}")

    t0 = time.perf_counter()
    res = evaluate(config, str(model_dir),
                   result_path=str(work / f"eval_{label}"),
                   device_voxelize=device_voxelize, device=device)
    wall = time.perf_counter() - t0
    check(metric in res["results"], f"{label} evaluate: no {metric} AP")
    official = res["results"][metric].splitlines()
    log(f"{label} evaluate(): {frames} frames in {wall:.3f} s "
        f"({frames / wall:.3f} fps with the set-up and the AP), "
        f"random start + {total} steps: " + " | ".join(official))
    return {name: module.launches for name, module, _, _ in KERNELS}


def phase_fhd_train(device, work):
    """Phase 10: car.fhd training through the port's entry points with
    the GT-database sampler, on a fixture tree made under ``work``.
    Returns the kernel launches of its train() and evaluate() runs and
    the tree's root."""
    root = fixture_tree(work, FHD_FRAMES, FHD_SCENE)
    config = fixture_config(CONFIG, root, work / "fhd.config",
                            FHD_TRAIN_STEPS)
    fhd_step_checks(config, root, device)
    fhd_train_runs(config, root, work, device, "fhd", FHD_TRAIN_STEPS,
                   FHD_RESUME_STEPS)
    launches = read_launches("fhd_train")
    log(f"fhd train: launches in the train() and evaluate() runs: "
        f"{launches}")

    return launches, root


def _route_rel(a, b):
    """max |a - b| over max |b|."""
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item()


def fhd_device_inference(ctx, device):
    """Run 1 of phase 11: ``N_FRAMES`` car.fhd requests at full width
    through ``InferenceContext(device_voxelize=True)``, the weights of
    ``ctx`` (phases 3-5), against the loaders' host plan
    (``planned_example``). Returns the kernel launches of the requests,
    and the most points a request shipped."""
    dctx = InferenceContext()
    dctx.build(CONFIG, device=device, device_voxelize=True)
    dctx.parts["net"].load_state_dict(ctx.parts["net"].state_dict())
    net, spec = dctx.parts["net"], dctx.parts["spec"]
    max_voxels = ctx.config.eval_input_reader.preprocess.max_number_of_voxels
    scales = plan_scales("SpMiddleFHD", dctx.parts["dense_shape"], max_voxels)
    frames = [make_kitti_scene(np.random.RandomState(i))[0]
              for i in range(N_FRAMES)]
    reset_launches()
    examples = []
    for i, points in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        example = dctx.get_inference_input_dict({}, points)
        t1 = time.perf_counter()
        dets = dctx.inference(example)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        boxes = dets[0]["box3d_lidar"]
        check(boxes.ndim == 2 and boxes.shape[1] == 7
              and np.isfinite(boxes).all(), f"device route frame {i}: bad "
              f"boxes")
        examples.append(example)
        log(f"fhd device route frame {i}: {len(points)} points, "
            f"{int(example['points_count'][0, 0])} shipped, "
            f"{len(boxes)} detections, host prep {(t1 - t0) * 1e3:.3f} ms, "
            f"device inference {(t2 - t1) * 1e3:.3f} ms, total "
            f"{(t2 - t0) * 1e3:.3f} ms")
    launches = {name: module.launches for name, module, _, _ in KERNELS}
    log(f"fhd device route: launches in the {N_FRAMES} requests: "
        f"{launches}")

    for i, (points, example) in enumerate(zip(frames, examples)):
        t0 = time.perf_counter()
        host = planned_example(ctx, points)
        host_ms = (time.perf_counter() - t0) * 1e3
        ex = example_to_device(example, device)
        with torch.no_grad():
            voxels, _, coords = dctx.route.voxelizer(ex["points"],
                                                     ex["points_count"])
            grid = from_voxel_coords(voxels[..., 0, :1], coords,
                                     scales[0]["shape"])
            plan, counts = build_device_plan(grid, scales)
        n = int(host["num_voxels"][0, 0])
        check(np.array_equal(grid.coords[0].cpu().numpy(),
                             host["coordinates"][0]),
              f"device route frame {i}: voxel coords differ from the host's")
        check(sorted(plan) == sorted(k for k in host
                                     if k.startswith("plan_")),
              f"device route frame {i}: plan keys {sorted(plan)}")
        for key, value in plan.items():
            check(np.array_equal(value[0].cpu().numpy(), host[key][0]),
                  f"device route frame {i}: {key} differs from the host "
                  f"plan's")
        check(np.array_equal(counts.cpu().numpy(),
                             host["sparse_active_counts"]),
              f"device route frame {i}: counts {counts.tolist()} vs "
              f"{host['sparse_active_counts'].tolist()}")
        preds_d, dets_d = dctx.run(example)
        preds_h, dets_h = ctx.run(host)
        rel = max(_route_rel(preds_d[k], preds_h[k]) for k in preds_h)
        frac, _, _ = _match(_ragged(dets_d), _ragged(dets_h))
        check(rel <= ROUTE_REL_TOL,
              f"device route frame {i}: preds rel err {rel} against the "
              f"host route")
        check(frac >= FRAME_MATCH_MIN,
              f"device route frame {i}: detections matched {frac}")
        h2d = {name: sum(v.nbytes for v in example_convert(e).values())
               for name, e in (("device route", example), ("host route",
                                                           host))}
        log(f"fhd device route frame {i}: {n} voxels, coords, every "
            f"plan_* key and the counts {counts[0].tolist()} equal to the "
            f"host plan's; preds against the host route rel err "
            f"{rel:.3e}, detections {int(dets_d['valid'].sum())} vs "
            f"{int(dets_h['valid'].sum())} matched {frac:.4f}; host prep "
            f"of the host route {host_ms:.3f} ms; H2D bytes "
            + ", ".join(f"{k} {v}" for k, v in h2d.items()))

    # frame 0, timed: the rulebooks per scale, and the device path
    # launched and as a CUDA-graph replay (no host sync on it)
    ex = example_to_device(examples[0], device)
    host = example_to_device(planned_example(ctx, frames[0]), device)
    hplan = {k: v for k, v in host.items() if k.startswith("plan_")}
    hnet = ctx.parts["net"]
    with torch.no_grad():
        voxels, num_points, coords = dctx.route.voxelizer(
            ex["points"], ex["points_count"])
        feats = voxels[..., 0, :1]

        def rulebooks(k):
            grid = from_voxel_coords(feats, coords, scales[0]["shape"])
            return build_device_plan(grid, scales[:k])

        def device_route():
            v, npts, c = dctx.route.voxelizer(ex["points"],
                                              ex["points_count"])
            return predict(spec, net(v, npts, c), ex)

        def host_route():
            return predict(spec, hnet(host["voxels"], host["num_points"],
                                      host["coordinates"], hplan), host)

        host_np = planned_example(ctx, frames[0])
        parts = {"h2d device route": cuda_ms(
            lambda: example_to_device(examples[0], device), iters=5,
            warmup=2), "h2d host route": cuda_ms(
            lambda: example_to_device(host_np, device), iters=5, warmup=2),
            "voxelize": cuda_ms(lambda: dctx.route.voxelizer(
                ex["points"], ex["points_count"]), iters=5, warmup=2)}
        graphs = {"voxelize": graph_ms(lambda: dctx.route.voxelizer(
            ex["points"], ex["points_count"]), iters=3, replays=3)}
        built, built_graph = [0.0], [0.0]
        for k in range(1, len(scales)):
            if scales[k - 1]["dense"]:
                break
            built.append(cuda_ms(lambda: rulebooks(k), iters=5, warmup=2))
            built_graph.append(graph_ms(lambda: rulebooks(k), iters=3,
                                        replays=3))
            parts[f"rulebooks scale {k - 1}"] = built[k] - built[k - 1]
            graphs[f"rulebooks scale {k - 1}"] = (built_graph[k]
                                                  - built_graph[k - 1])
        parts["device route"] = cuda_ms(device_route, iters=5, warmup=2)
        parts["host route"] = cuda_ms(host_route, iters=5, warmup=2)
        graphs["device route"] = graph_ms(device_route, iters=3, replays=3)
        graphs["host route"] = graph_ms(host_route, iters=3, replays=3)
    log("fhd device route breakdown (ms launched, CUDA-synchronised, frame "
        "0; each rulebook scale the growth of the builders' time with it; "
        "each route voxels or uploaded voxels and plan -> detections): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    log("fhd device route, device-only (CUDA graph, frame 0): " + ", ".join(
        f"{k} {v:.3f}" for k, v in graphs.items()))
    return launches, max(int(e["points_count"].max()) for e in examples)


def _module_grads(module, out, g):
    """The gradients of sum(out * g) over ``module``'s parameters."""
    params = [p for p in module.parameters()]
    return torch.autograd.grad((out * g).sum(), params)


def fhd_device_modules(device):
    """Run 3 of phase 11: the other five sparse middles and both sparse
    residual blocks, forward and backward in training mode, on both
    rulebook routes on the card and on the device route on the CPU, on
    ``make_kitti_scene`` frame 5 voxelized at half car.fhd's xy
    resolution ([800, 704]), z at 0.1 m (41 cells) or at 0.05 m (81: the
    HRZ variants and 2K collapse 41)."""
    points = torch.from_numpy(make_kitti_scene(np.random.RandomState(5))[0])
    g = torch.Generator().manual_seed(5)

    def voxel_coords(nz):
        _, coords, _, _ = voxelize(points, points.shape[0],
                                   (0.1, 0.1, 4.0 / nz), (0.0, -40.0, -3.0),
                                   (704, 800, nz), MODULE_VOXELS, 1)
        return coords, (nz + 1, 800, 704)

    for name in sorted(SPARSE_MIDDLE_NAMES - {"SpMiddleFHD"}):
        nz = 80 if ("HRZ" in name or "2K" in name) else 40
        coords, shape = voxel_coords(nz)
        feats = torch.randn(MODULE_VOXELS, 4, generator=g)
        middle = get_middle_class(name)((1, nz, 800, 704, 4),
                                        num_input_features=4)
        init_weights(middle, torch.Generator().manual_seed(0))
        scales = plan_scales(name, (1, nz, 800, 704, 4), MODULE_VOXELS)
        grid = from_voxel_coords(feats[None], coords[None], shape)
        hplan = build_host_plan(grid.coords[0].numpy(), scales)
        runs = {}
        for label, dev, plan in (
                ("card device route", device, None),
                ("card host route", device, hplan), ("cpu", "cpu", None)):
            mod = copy.deepcopy(middle).to(dev).train()
            p = None if plan is None else {
                k: torch.from_numpy(v)[None].to(dev) for k, v in plan.items()}
            out = mod(grid.features.to(dev), grid.coords.to(dev), p)
            gout = torch.randn(out.shape, generator=torch.Generator()
                               .manual_seed(1)).to(dev)
            runs[label] = (out.detach().cpu(),
                           [x.cpu() for x in _module_grads(mod, out, gout)])
        _compare_runs(name, runs, int((coords[:, 0] >= 0).sum()))

    coords, shape = voxel_coords(40)
    grid = from_voxel_coords(torch.randn(1, MODULE_VOXELS, 16, generator=g),
                             coords[None], shape)
    slots, _ = build_subm_rulebook(grid, (3, 3, 3))
    hslots = torch.from_numpy(native_plan.subm_plan(
        grid.coords[0].numpy(), shape, _kernel_offsets((3, 3, 3)) - 1))[None]
    for block in (SparseBasicBlock(16, 32), SparseBottleneck(16, 16)):
        init_weights(block, torch.Generator().manual_seed(0))
        runs = {}
        for label, dev, rule in (("card device route", device, None),
                                 ("card host route", device, hslots),
                                 ("cpu", "cpu", slots)):
            mod = copy.deepcopy(block).to(dev).train()
            gd = SparseGrid(*(t.to(dev) for t in grid[:3]), grid.shape)
            rule = (build_subm_rulebook(gd, (3, 3, 3))[0] if rule is None
                    else rule.to(dev))
            out = mod(gd, rule).features
            gout = torch.randn(out.shape, generator=torch.Generator()
                               .manual_seed(1)).to(dev)
            runs[label] = (out.detach().cpu(),
                           [x.cpu() for x in _module_grads(mod, out, gout)])
        _compare_runs(type(block).__name__, runs,
                      int(grid.valid.sum()))


def _compare_runs(name, runs, active):
    """Both routes on the card agree bitwise; the card against the CPU:
    outputs within PREDS_REL_TOL of their largest magnitude, gradients
    within TRAIN_GRAD_L2_TOL in L2."""
    out_d, grads_d = runs["card device route"]
    out_h, grads_h = runs["card host route"]
    out_c, grads_c = runs["cpu"]
    same = torch.equal(out_d, out_h) and all(
        torch.equal(a, b) for a, b in zip(grads_d, grads_h))
    check(same, f"{name}: the device and host routes differ on the card")
    rel = _route_rel(out_d, out_c)
    l2 = max(((a - b).norm() / b.norm().clamp(min=1e-30)).item()
             for a, b in zip(grads_d, grads_c))
    check(rel <= PREDS_REL_TOL, f"{name}: card vs CPU rel err {rel}")
    check(l2 <= TRAIN_GRAD_L2_TOL, f"{name}: card vs CPU gradient L2 {l2}")
    log(f"{name}: {active} active voxels, out {tuple(out_d.shape)}, "
        f"forward and backward in training mode: device route == host "
        f"route on the card (bitwise), card vs CPU out rel err {rel:.3e}, "
        f"gradients worst L2 {l2:.3e} over {len(grads_d)} tensors")


def phase_fhd_device(ctx, device, root, work):
    """Phase 11: car.fhd on the device route (points shipped, voxels and
    rulebooks built on the card). Returns the kernel launches of its
    requests, train() and evaluate() runs."""
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        inf_launches, most = fhd_device_inference(ctx, device)
        config = fixture_config(CONFIG, root, work / "fhd_device.config",
                                FHD_DEVICE_STEPS)
        fhd_step_checks(config, root, device, device_route=True)
        train_launches = fhd_train_runs(
            config, root, work, device, "fhd_device", FHD_DEVICE_STEPS,
            FHD_DEVICE_RESUME, device_voxelize=True)
    overflows = [w for w in rec if "emit_points buffer overflow"
                 in str(w.message)]
    launches = {k: inf_launches[k] + train_launches[k] for k in inf_launches}
    for kernel in PATH_KERNELS["fhd_device"]:
        check(launches[kernel] > 0,
              f"the fhd_device path never launched {kernel}")
    log(f"fhd device route: launches in the requests, train() and "
        f"evaluate() runs: {launches}; most points a request shipped "
        f"{most} of {POINTS_BUFFER}; points buffer overflow warnings "
        f"{len(overflows)}")
    fhd_device_modules(device)
    log(f"phase 11 (fhd_device): {time.perf_counter() - t0:.3f} s")
    return launches


def _by_class(dets, ci):
    """Frame 0's valid detections of class ``ci`` (host arrays)."""
    keep = (dets["valid"][0] & (dets["label_preds"][0] == ci)).cpu().numpy()
    return {k: dets[k][0].cpu().numpy()[keep]
            for k in ("box3d_lidar", "scores")}


def all_fhd_requests(ctx, label):
    """``N_FRAMES`` all.fhd requests through ``ctx``: the detections per
    class and the CUDA-synchronised host and device ms of each. Returns
    each frame's K3 and K4 launches."""
    classes = ctx.parts["target_assigner"].classes
    per_frame = []
    for i in range(N_FRAMES):
        points = make_kitti_scene(np.random.RandomState(i))[0]
        k3, k4 = cuda_iou.launches, cuda_nms.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        example = ctx.get_inference_input_dict({}, points)
        t1 = time.perf_counter()
        dets = ctx.inference(example)[0]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        boxes = dets["box3d_lidar"]
        check(boxes.ndim == 2 and boxes.shape[1] == 7
              and np.isfinite(boxes).all(), f"{label} frame {i}: bad boxes")
        per_frame.append((cuda_iou.launches - k3, cuda_nms.launches - k4))
        by_class = {name: int((dets["label_preds"] == c).sum())
                    for c, name in enumerate(classes)}
        log(f"{label} frame {i}: {len(points)} points, {len(boxes)} "
            f"detections {by_class}, host prep {(t1 - t0) * 1e3:.3f} ms, "
            f"device inference {(t2 - t1) * 1e3:.3f} ms, total "
            f"{(t2 - t0) * 1e3:.3f} ms; K3 +{per_frame[-1][0]}, K4 "
            f"+{per_frame[-1][1]}")
    return per_frame


def all_fhd_reference(mctx, device):
    """Frame 0 through all.fhd under multi-class NMS (``mctx``) on the
    card and on the CPU with the plain kernels: the preds, the
    detections matched class by class, and each class's NMS candidates
    of the CPU run through K3 and K4 on the card."""
    example = mctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(0))[0])
    preds, dets = mctx.run(example)
    cpu = InferenceContext()
    cpu.build(mctx.config, device="cpu")
    cpu.parts["net"].load_state_dict(mctx.parts["net"].state_dict())
    t0 = time.perf_counter()
    preds_cpu, dets_cpu = cpu.run(example)
    log(f"all.fhd reference: frame 0 on the CPU took "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    for key in preds:
        rel = _route_rel(preds[key].cpu(), preds_cpu[key])
        check(rel <= PREDS_REL_TOL,
              f"all.fhd {key}: card vs CPU rel err {rel} > {PREDS_REL_TOL}")
        log(f"all.fhd reference: {key} {tuple(preds_cpu[key].shape)} card "
            f"vs CPU rel err {rel:.3e}")
    spec = mctx.parts["spec"]
    matched = total = 0
    for ci, name in enumerate(mctx.parts["target_assigner"].classes):
        card, ref = _by_class(dets, ci), _by_class(dets_cpu, ci)
        frac, _, _ = _match(card, ref)
        n = max(len(card["scores"]), len(ref["scores"]))
        matched, total = matched + frac * n, total + n
        log(f"all.fhd reference: {name} detections card "
            f"{len(card['scores'])}, CPU {len(ref['scores'])}, matched "
            f"{frac:.4f}")
    frac = matched / total if total else 1.0
    check(total > 0, "all.fhd frame 0 produced no detections")
    check(frac >= FRAME_MATCH_MIN,
          f"all.fhd detections matched class by class {frac} < "
          f"{FRAME_MATCH_MIN}")
    anchors = torch.from_numpy(example["anchors"].astype(np.float32))
    for ci in range(spec.num_class):
        straddles, keep_diff = _nms_disagreement(spec, preds_cpu, anchors,
                                                 device, ci)
        check(straddles == 0 and keep_diff == 0,
              f"all.fhd class {ci}: K3/K4 on the CPU's candidates: "
              f"{straddles} IoU pairs straddle the threshold, {keep_diff} "
              f"keep flags differ")


def _zoo_case(name, module, inputs, run, device, seed,
              grad_tol=ZOO_GRAD_L2_TOL):
    """``run(module, *inputs)`` (a tensor or a dict of them) in training
    mode from the same weights and inputs on the card, on the CPU and on
    the CPU in float64, and the first input's gradient of sum(out * g)
    for a random g: the card's outputs within ``ZOO_REL_TOL`` of the
    CPU's largest magnitude, its gradient within ``grad_tol`` of the
    float64 gradient in L2 (the CPU's own fp32 error printed beside)."""
    runs = {}
    for label, dev, dtype in (("cpu64", "cpu", torch.float64),
                              ("cpu", "cpu", torch.float32),
                              ("card", device, torch.float32)):
        def cast(t):
            return t.to(dev, dtype) if t.is_floating_point() else t.to(dev)

        mod = (None if module is None
               else copy.deepcopy(module).to(dev, dtype).train())
        x = cast(inputs[0]).requires_grad_(True)
        out = run(mod, x, *(cast(t) for t in inputs[1:]))
        out = out if isinstance(out, dict) else {"out": out}
        gen = torch.Generator().manual_seed(seed)
        loss = sum((out[k] * torch.randn(out[k].shape, generator=gen)
                    .to(dev, dtype)).sum() for k in sorted(out))
        (grad,) = torch.autograd.grad(loss, x)
        runs[label] = ({k: v.detach().cpu() for k, v in out.items()},
                       grad.cpu().double())
    (out_c, grad_c), (out_d, grad_d) = runs["cpu"], runs["card"]
    grad_64 = runs["cpu64"][1]
    check(all(torch.isfinite(v).all() for v in out_d.values())
          and torch.isfinite(grad_d).all(), f"zoo {name}: not finite")
    rel = max(_route_rel(out_d[k], out_c[k]) for k in out_c)

    def l2(a):
        return ((a - grad_64).norm() / grad_64.norm().clamp(min=1e-30)).item()

    check(rel <= ZOO_REL_TOL, f"zoo {name}: card vs CPU rel err {rel}")
    check(l2(grad_d) <= grad_tol,
          f"zoo {name}: input gradient L2 {l2(grad_d)} off float64")
    log(f"zoo {name}: outputs "
        f"{ {k: tuple(v.shape) for k, v in out_c.items()} }, training mode, "
        f"card vs CPU rel err {rel:.3e}; input gradient off the float64 "
        f"CPU run in L2: card {l2(grad_d):.3e}, CPU fp32 {l2(grad_c):.3e} "
        f"(limit {grad_tol:g})")


def all_fhd_zoo(device):
    """The zoo modules the slice ported, at small widths, card against
    CPU, forward and backward: the four encoders (VFELayer, the two VFE
    stacks, SimpleVoxelRadius) on 4000 voxels of 5 slots, a GroupNorm
    RPNV2, RPNNoHead and ResNetRPN on a [2, 64, 96, 96] map,
    bev_box_decode and the GHM losses on 2 x 20000 anchors."""
    from second_tpu_torch.models.voxel_encoders import VFELayer

    g = torch.Generator().manual_seed(12)
    counts = torch.randint(0, 6, (2, 4000), generator=g, dtype=torch.int32)
    voxels = torch.randn(2, 4000, 5, 4, generator=g) * (
        torch.arange(5)[None, None, :, None] < counts[..., None, None])
    coords = torch.zeros(2, 4000, 3, dtype=torch.int32)

    def init(module):
        init_weights(module, torch.Generator().manual_seed(0))
        return module

    vfe = init(VFELayer(7, 32))
    _zoo_case("VFELayer", vfe, (torch.randn(2, 4000, 5, 7, generator=g),
                                counts > 0),
              lambda m, x, mask: m(x, mask), device, 1)
    for name, filters in (("VoxelFeatureExtractor", (32, 64)),
                          ("VoxelFeatureExtractorV2", (16, 32, 64)),
                          ("SimpleVoxelRadius", (16,))):
        module = init(get_vfe_class(name)(num_input_features=4,
                                          num_filters=filters))
        _zoo_case(name, module, (voxels, counts, coords),
                  lambda m, *a: m(*a), device, 2)
    rpn = dict(num_class=4, layer_nums=(2, 2), layer_strides=(1, 2),
               num_filters=(32, 64), upsample_strides=(1, 2),
               num_upsample_filters=(32, 32), num_input_features=64,
               num_anchor_per_loc=8, box_code_size=7, num_direction_bins=2)
    bev = torch.randn(2, 64, 96, 96, generator=g)
    for name, extra in (("RPNV2", dict(use_groupnorm=True, num_groups=8)),
                        ("RPNNoHead", {}), ("ResNetRPN", {})):
        module = init(get_rpn_class(name)(**rpn, **extra))
        label = "RPNV2 (GroupNorm)" if name == "RPNV2" else name
        # conv stacks with ReLU gates: TRAIN_GRAD_L2_TOL, as phase 7
        _zoo_case(label, module, (bev,), lambda m, x: m(x), device, 3,
                  grad_tol=TRAIN_GRAD_L2_TOL)
    n = 20000
    anchors = torch.stack([
        torch.rand(n, generator=g) * 70, torch.rand(n, generator=g) * 80 - 40,
        torch.rand(n, generator=g) * 2 + 0.5,
        torch.rand(n, generator=g) * 4 + 0.8,
        torch.rand(n, generator=g) * 1.57], 1)
    _zoo_case("bev_box_decode", None,
              (torch.randn(n, 5, generator=g) * 0.3, anchors),
              lambda _, e, a: box_ops_torch.bev_box_decode(e, a), device, 4)
    labels = torch.randint(-1, 5, (2, n), generator=g)
    onehot = torch.nn.functional.one_hot(labels.clamp(min=0), 5)[..., 1:]
    weights = (labels >= 0).float()
    _zoo_case("GHM-C", None, (torch.randn(2, n, 4, generator=g) * 2,
                              onehot.float(), weights),
              lambda _, x, t, w: losses.ghm_c_loss(x, t, w), device, 5)
    _zoo_case("GHM-R", None, (torch.randn(2, n, 7, generator=g) * 0.5,
                              torch.randn(2, n, 7, generator=g) * 0.5,
                              weights),
              lambda _, x, t, w: losses.ghm_r_loss(x, t, w), device, 6)


def phase_all_fhd(device, work):
    """Phase 12: all.fhd, the KITTI multi-class SECOND, through the
    port's entry points. Returns the kernel launches of its requests,
    train() and evaluate() runs."""
    t_phase = time.perf_counter()
    ctx = InferenceContext()
    ctx.build(ALL_CONFIG, device=device)
    ctx.init_random(0)
    state = ctx.parts["net"].state_dict()
    dctx = InferenceContext()
    dctx.build(ALL_CONFIG, device=device, device_voxelize=True)
    dctx.parts["net"].load_state_dict(state)
    cfg = load_pipeline_config(ALL_CONFIG)
    settings = cfg.model.second.target_assigner.class_settings
    published = [c.use_multi_class_nms for c in settings]
    for c in settings:
        c.use_multi_class_nms = True
    mctx = InferenceContext()
    mctx.build(cfg, device=device)
    mctx.parts["net"].load_state_dict(state)
    n = mctx.parts["spec"].num_class
    log(f"all.fhd: {n} classes {ctx.parts['target_assigner'].classes}, "
        f"{ctx.parts['anchor_cache']['anchors'].shape[0]} anchors; the "
        f"published file sets use_multi_class_nms {published}, so the "
        f"multi-class run sets it on every class")

    reset_launches()
    for label, c, per_class in (("all.fhd host voxels", ctx, False),
                                ("all.fhd device route", dctx, False),
                                ("all.fhd multi-class NMS", mctx, True)):
        nms = n if per_class else 1
        per_frame = all_fhd_requests(c, label)
        check(all(f == (nms, 2 * nms) for f in per_frame),
              f"{label}: K3/K4 launches per frame {per_frame}, expected "
              f"{(nms, 2 * nms)}")
    launches = {name: module.launches for name, module, _, _ in KERNELS}
    log(f"all.fhd: launches in the {3 * N_FRAMES} requests: {launches}")
    all_fhd_reference(mctx, device)

    work.mkdir()
    root = fixture_tree(work, ALL_FRAMES, ALL_SCENE)
    config = fixture_config(ALL_CONFIG, root, work / "all_fhd.config",
                            ALL_TRAIN_STEPS)
    fhd_step_checks(config, root, device, label="all.fhd")
    train_launches = fhd_train_runs(
        config, root, work, device, "all_fhd", ALL_TRAIN_STEPS, 0,
        base_config=ALL_CONFIG, frames=ALL_FRAMES)
    launches = {k: launches[k] + train_launches[k] for k in launches}
    for kernel in PATH_KERNELS["all_fhd"]:
        check(launches[kernel] > 0,
              f"the all_fhd path never launched {kernel}")
    log(f"all.fhd: launches in the requests, train() and evaluate() runs: "
        f"{launches}")
    all_fhd_zoo(device)
    log(f"phase 12 (all_fhd): {time.perf_counter() - t_phase:.3f} s")
    return launches


def k1_bf16_kernel(ctx, device):
    """K1-bf16 against its plain version (bf16, f32 sums rounded once)
    on the 10 sparse convs of phase 2's frame, with the weights of
    ``ctx`` cast to bf16: max error, in absolute terms and in bf16 ulps
    of the plain value, two calls bitwise equal, the wrapper's ms, the
    device-only ms (20 calls in a CUDA graph) and the plain ms, and the
    bound (bf16 bytes at 3.35 TB/s, 2 operations per hit at 989
    TFLOP/s)."""
    example = planned_example(
        ctx, make_kitti_scene(np.random.RandomState(100))[0])
    mid = ctx.parts["net"].middle_feature_extractor
    g = torch.Generator().manual_seed(0)
    in_rows = conv_rows(example)
    errs, ulps, k_ms, d_ms, p_ms, b_ms = [], [], 0.0, 0.0, 0.0, {}
    for wname, pname, _ in SPARSE_CONVS:
        w = getattr(mid, wname).detach().bfloat16()
        k, cin, cout = w.shape
        slots = torch.from_numpy(example[pname].astype(np.int32)).to(device)
        feat = torch.randn(1, in_rows[pname], cin,
                           generator=g).to(device).bfloat16()
        nbytes, ops = gather_conv_bound(1, in_rows[pname], cin, slots, cout,
                                        False, elem=2)
        bms, bby = bf16_bound_ms(nbytes, ops)
        b_ms[bby] = b_ms.get(bby, 0.0) + bms
        out = cuda_sparse_conv.gather_gemm(feat, slots, w)
        ref = cuda_sparse_conv.gather_gemm_plain(feat, slots, w).float()
        check(out.dtype == torch.bfloat16, f"K1-bf16 {wname}: {out.dtype}")
        diff = (out.float() - ref).abs()
        tol = BF16_ULP * ref.abs() + 1e-5 * ref.abs().max()
        check(bool((diff <= tol).all()),
              f"K1-bf16 {wname}: {int((diff > tol).sum())} elements beyond "
              "one bf16 ulp")
        check(torch.equal(out, cuda_sparse_conv.gather_gemm(feat, slots, w)),
              f"K1-bf16 {wname}: two calls differ")
        # in bf16 ulps of the plain value, 2^(floor(log2 |x|) - 7), where
        # it passes 1e-3 of the largest magnitude (below, the f32 sums
        # cancel, and their order decides more than an ulp of the result)
        big = ref.abs() >= 1e-3 * ref.abs().max()
        ulp = torch.exp2(torch.floor(torch.log2(ref[big].abs())) - 7)
        ulps.append((diff[big] / ulp).max().item())
        kms = cuda_ms(lambda: cuda_sparse_conv.gather_gemm(feat, slots, w))
        dms = graph_ms(lambda: cuda_sparse_conv.gather_gemm(feat, slots, w))
        pms = cuda_ms(
            lambda: cuda_sparse_conv.gather_gemm_plain(feat, slots, w))
        errs.append(diff.max().item())
        k_ms += kms
        d_ms += dms
        p_ms += pms
        log(f"K1-bf16 {wname}: rows {tuple(feat.shape[1:])} -> "
            f"{tuple(slots.shape[1:])} x {cout}, max err {errs[-1]:.3e} "
            f"({ulps[-1]:.3f} bf16 ulps above 1e-3 of the largest value; "
            f"{(diff == 0).float().mean().item():.6f} of the elements "
            f"bitwise equal), two calls bitwise equal, kernel "
            f"{kms:.4f} ms (device {dms:.4f}), plain {pms:.4f} ms, bound "
            f"{bms:.5f} ms ({bby}); {ops / 1e9:.3f} GFLOP of hits at "
            f"{ops / dms / 1e9:.3f} TFLOP/s, {nbytes / 1e6:.1f} MB")
    log(f"K1-bf16 frame total (10 convs): kernel {k_ms:.4f} ms (device "
        f"{d_ms:.4f}), plain {p_ms:.4f} ms, bound "
        f"{sum(b_ms.values()):.5f} ms ({b_ms})")
    return {"max_abs_err": max(errs), "max_err_ulps": max(ulps),
            "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
            "bound_ms": sum(b_ms.values()),
            "bound_by": max(b_ms, key=b_ms.get), "library_ms": None}


def _norms_away_from_identity(net, seed):
    """Every batch norm of ``net`` drawn away from identity, as the CPU
    parity tests draw them (tests/test_torch_slice.py): running means and
    biases in [-0.1, 0.1], running variances and scales in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, MaskedBatchNorm):
                for t, lo, hi in ((module.running_mean, -0.1, 0.1),
                                  (module.bias, -0.1, 0.1),
                                  (module.running_var, 0.5, 1.5),
                                  (module.weight, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(
                        rng.uniform(lo, hi, t.shape).astype(np.float32)))


def _f32_ctx(config, device, device_voxelize=False):
    """An f32 ``InferenceContext`` of ``config``: random weights from
    seed 0, batch norms away from identity."""
    ctx = InferenceContext()
    ctx.build(config, device=device, device_voxelize=device_voxelize)
    ctx.init_random(0)
    _norms_away_from_identity(ctx.parts["net"], 0)
    return ctx


def _mixed_ctx(config, state, device, device_voxelize=False):
    """An ``InferenceContext`` of ``config`` under mixed precision
    (``enable_mixed_precision``), its f32 weights ``state``."""
    cfg = (load_pipeline_config(config) if isinstance(config, str)
           else copy.deepcopy(config))
    cfg.train_config.enable_mixed_precision = True
    ctx = InferenceContext()
    ctx.build(cfg, device=device, device_voxelize=device_voxelize)
    ctx.parts["net"].load_state_dict(state)
    check(ctx.parts["net"].compute_dtype == torch.bfloat16,
          "mixed precision did not build a bf16 network")
    return ctx


def _f32_preds(ctx, frames):
    """``ctx``'s preds of ``make_kitti_scene`` frames 0..frames-1."""
    return [{k: v.float() for k, v in ctx.run(ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(i))[0]))[0].items()}
            for i in range(frames)]


def bf16_requests(label, ctx, refs):
    """A request of each ``make_kitti_scene`` frame through the bf16
    ``ctx`` (host preparation and device inference, CUDA-synchronised;
    the detections), then its preds against ``refs``, the f32 preds of
    the same frames on the card."""
    worst = 0.0
    for i, ref in enumerate(refs):
        points = make_kitti_scene(np.random.RandomState(i))[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        example = ctx.get_inference_input_dict({}, points)
        t1 = time.perf_counter()
        dets = ctx.inference(example)[0]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        boxes = dets["box3d_lidar"]
        check(boxes.ndim == 2 and boxes.shape[1] == 7
              and np.isfinite(boxes).all(), f"{label} frame {i}: bad boxes")
        preds, _ = ctx.run(example)
        errs = {k: _route_rel(preds[k].float(), ref[k]) for k in ref}
        worst = max(worst, *errs.values())
        check(all(e <= BF16_PREDS_TOL for e in errs.values()),
              f"{label} frame {i}: bf16 preds vs f32 {errs}")
        log(f"{label} frame {i}: {len(points)} points, {len(boxes)} "
            f"detections, host prep {(t1 - t0) * 1e3:.3f} ms, device "
            f"inference {(t2 - t1) * 1e3:.3f} ms, total "
            f"{(t2 - t0) * 1e3:.3f} ms; preds vs f32 on the card " + ", ".join(
                f"{k} {e:.3e}" for k, e in errs.items()))
    return worst


def pp_bf16_step_reference(device):
    """A PointPillars bf16 train step at batch 1 on the card against the
    CPU's bf16 step (loss) and a float64 CPU step (gradients), and the
    host syncs of a bf16 step at batch 2."""
    cfg = without_sampler(load_pipeline_config(PP_CONFIG))
    cfg.train_config.enable_mixed_precision = True
    parts = build_network(cfg, device)
    init_weights(parts["net"], torch.Generator().manual_seed(0))
    route = make_route(parts, cfg.train_input_reader, "train", True)
    prep = build_prep_func(cfg.train_input_reader, parts, training=True,
                           route=route)
    np.random.seed(0)
    batch = merge_second_batch([prep(input_dict=train_input(i))
                                for i in range(2)])
    batch1 = {k: v[:1] for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    loss_d, grads_d = loss_and_grads(
        parts["net"], parts["spec"], example_to_device(batch1, device),
        route)
    t0 = time.perf_counter()
    cpu = build_network(cfg, "cpu")
    cpu["net"].load_state_dict(parts["net"].state_dict())
    ex = example_to_device(batch1, "cpu")
    loss_c, grads_c = loss_and_grads(cpu["net"], cpu["spec"], ex, route)
    cfg64 = copy.deepcopy(cfg)
    cfg64.train_config.enable_mixed_precision = False
    cpu64 = build_network(cfg64, "cpu")
    cpu64["net"].load_state_dict(parts["net"].state_dict())
    ex64 = {k: v.double() if v.is_floating_point() else v
            for k, v in ex.items()}
    _, grads_64 = loss_and_grads(cpu64["net"].double(), cpu64["spec"], ex64,
                                 route)
    log(f"pp bf16 reference: batch 1 on the CPU in bf16 and float64 took "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    rel = abs(loss_d - loss_c) / abs(loss_c)
    check(rel <= BF16_LOSS_REL_TOL,
          f"pp bf16 loss card {loss_d} vs CPU {loss_c}: rel {rel}")

    def l2(a, ref):
        return ((a.cpu().double() - ref).norm()
                / ref.norm().clamp(min=1e-30)).item()

    worst = (0.0, 0.0, None)
    for name, ref in grads_64.items():
        check(grads_d[name].dtype == torch.float32,
              f"pp bf16 gradient {name} is {grads_d[name].dtype}")
        e_d, e_c = l2(grads_d[name], ref), l2(grads_c[name], ref)
        check(e_d <= max(BF16_GRAD_L2_TOL, 2 * e_c),
              f"pp bf16 gradient {name}: card {e_d:.3e}, CPU bf16 "
              f"{e_c:.3e} from float64 (L2)")
        worst = max(worst, (e_d, e_c, name))
    log(f"pp bf16 reference: batch 1 loss card {loss_d:.6f}, CPU bf16 "
        f"{loss_c:.6f} (rel {rel:.3e}); gradients f32, the card's worst "
        f"L2 from float64 {worst[2]} at {worst[0]:.3e} (the CPU bf16 "
        f"step's {worst[1]:.3e})")
    opt, lr_fn, mom_fn = opt_builder.build(
        cfg.train_config.optimizer, cfg.train_config.steps,
        list(parts["net"].parameters()))
    step = make_train_step(parts["net"], parts["spec"], opt, lr_fn, mom_fn,
                           route=route)
    n, first = sync_count(step, example_to_device(batch, device))
    check(n == 0, f"pp bf16 train step: {n} host syncs{first}")
    log(f"pp bf16 train step at batch 2: {n} host syncs under CUDA's sync "
        f"debug mode")


def phase_bf16(ctx, device, work, pp_root, fhd_root):
    """Phase 13: mixed precision. K1-bf16 alone; then, counted as the
    ``bf16`` path, car.fhd requests in bf16 on both routes, all.fhd's on
    the device route and PointPillars', each against the same frames'
    f32 preds on the card (random weights from seed 0 with batch norms
    away from identity), PointPillars' bf16 ``train`` and
    ``evaluate`` on phase 9's tree and car.fhd's bf16 ``evaluate`` of
    phase 10's checkpoint; then a PointPillars bf16 step against the CPU
    and its host syncs, and car.fhd's bf16 ``train``, which must raise.
    Returns the ``bf16`` path's launches and K1-bf16's results."""
    t_phase = time.perf_counter()
    results = k1_bf16_kernel(ctx, device)
    # init_weights' batch norms are the identity: there bf16 parts
    # further from f32 (as the JAX package's own default init does on the
    # CPU), shown here for frame 0 and not held
    init = _mixed_ctx(CONFIG, ctx.parts["net"].state_dict(), device)
    example = ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(0))[0])
    p32, p16 = ctx.run(example)[0], init.run(example)[0]
    log("car.fhd frame 0 with init_weights' identity batch norms, bf16 vs "
        "f32 (max |diff| over the largest f32 value, not held): " + ", ".join(
            f"{k} {_route_rel(p16[k], p32[k]):.3e}" for k in p32))
    del init, p32, p16
    fhd32 = _f32_ctx(CONFIG, device)
    state = fhd32.parts["net"].state_dict()
    fhd_host = _mixed_ctx(CONFIG, state, device)
    fhd_dev = _mixed_ctx(CONFIG, state, device, device_voxelize=True)
    fhd_refs = _f32_preds(fhd32, N_FRAMES)
    all32 = _f32_ctx(ALL_CONFIG, device, device_voxelize=True)
    all_ctx = _mixed_ctx(ALL_CONFIG, all32.parts["net"].state_dict(), device,
                         device_voxelize=True)
    all_refs = _f32_preds(all32, BF16_ALL_FRAMES)
    pp32 = _f32_ctx(PP_CONFIG, device)
    pp_ctx = _mixed_ctx(PP_CONFIG, pp32.parts["net"].state_dict(), device)
    pp_refs = _f32_preds(pp32, N_FRAMES)
    del fhd32, all32, pp32

    reset_launches()
    worst = {}
    for label, c, refs in (("car.fhd bf16 host voxels", fhd_host, fhd_refs),
                           ("car.fhd bf16 device route", fhd_dev, fhd_refs)):
        worst[label] = bf16_requests(label, c, refs)
    check(cuda_sparse_conv.launches == 0,
          "the car.fhd bf16 requests launched K1 (fp32)")
    check(cuda_sparse_conv_bf16.launches > 0,
          "the car.fhd bf16 requests never launched K1-bf16")
    worst["all.fhd bf16 device route"] = bf16_requests(
        "all.fhd bf16 device route", all_ctx, all_refs)
    worst["PointPillars bf16"] = bf16_requests("PointPillars bf16", pp_ctx,
                                               pp_refs)
    launches = {name: module.launches for name, module, _, _ in KERNELS}
    counts = fhd_train_runs(
        fixture_config(PP_CONFIG, pp_root, work / "pp_bf16.config",
                       PP_BF16_STEPS, mixed_precision=True),
        pp_root, work, device, "pp_bf16", PP_BF16_STEPS, PP_BF16_RESUME,
        base_config=PP_CONFIG, frames=PP_FRAMES, mixed_precision=True)
    launches = {k: launches[k] + counts[k] for k in launches}
    ckpt = torch.load(
        work / "model_pp_bf16" / f"voxelnet-{PP_BF16_STEPS}.ckpt",
        map_location="cpu", weights_only=False)
    dtypes = {v.dtype for v in ckpt["net"].values() if v.is_floating_point()}
    check(dtypes == {torch.float32}, f"pp bf16 checkpoint dtypes {dtypes}")
    config = fixture_config(CONFIG, fhd_root, work / "fhd_bf16.config",
                            FHD_TRAIN_STEPS, mixed_precision=True)
    reset_launches()
    t0 = time.perf_counter()
    res = evaluate(config, str(work / "model_fhd"),
                   result_path=str(work / "eval_fhd_bf16"), device=device)
    wall = time.perf_counter() - t0
    check("official" in res["results"], "car.fhd bf16 evaluate: no AP")
    launches = {name: launches[name] + module.launches
                for name, module, _, _ in KERNELS}
    for kernel in PATH_KERNELS["bf16"]:
        check(launches[kernel] > 0, f"the bf16 path never launched {kernel}")
    log(f"pp bf16: checkpoint dtypes {sorted(map(str, dtypes))}; car.fhd "
        f"bf16 evaluate() of phase 10's checkpoint: {FHD_FRAMES} frames in "
        f"{wall:.3f} s: "
        + " | ".join(res["results"]["official"].splitlines()[:5]))
    log(f"bf16: launches in the requests, train() and evaluate() runs: "
        f"{launches}; worst preds vs f32 {worst}")

    pp_bf16_step_reference(device)
    try:
        train(config, str(work / "model_fhd_bf16"), device=device)
    except NotImplementedError as err:
        check("ROADMAP.md" in str(err), f"the refusal names no ROADMAP: {err}")
        log(f"car.fhd bf16 train() refused: {err}")
    else:
        raise AssertionError("car.fhd bf16 train() did not raise")
    log(f"phase 13 (bf16): {time.perf_counter() - t_phase:.3f} s")
    return launches, results


def nusc_config(root, path, steps):
    """The published mhead config reading the fixture tree at ``root``
    (its infos and GT database), ``steps`` steps, no periodic eval or
    timed checkpoint within them."""
    cfg = load_pipeline_config(MHEAD_CONFIG)
    for reader, split in ((cfg.train_input_reader, "train"),
                          (cfg.eval_input_reader, "val")):
        reader.dataset.kitti_root_path = str(root)
        reader.dataset.kitti_info_path = str(root / f"infos_{split}.pkl")
    cfg.train_input_reader.preprocess.database_sampler.database_info_path = (
        str(root / "kitti_dbinfos_train.pkl"))
    cfg.train_config.steps = steps
    cfg.train_config.save_checkpoints_secs = 3600
    path.write_text(cfg.to_text())
    return str(path)


def nusc_requests(ctx, dataset):
    """``N_FRAMES`` requests of the fixture's frames (a nuScenes info,
    its 10 accumulated sweeps): host preparation and device inference
    (CUDA-synchronised), the points shipped against those in range, the
    points buffer's overflow warnings (none allowed), the detections per
    class. Returns the kernel launches made during them."""
    spec, gen = ctx.parts["spec"], ctx.parts["voxel_generator"]
    names = ctx.parts["target_assigner"].classes
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for i in range(N_FRAMES):
        sensor = dataset.get_sensor_data(i)
        points = sensor["lidar"]["points"]
        in_range = pad_points(points, gen.point_cloud_range,
                              len(points))[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            example = ctx.get_inference_input_dict(sensor["metadata"],
                                                   points)
        t1 = time.perf_counter()
        dets = ctx.inference(example)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        overflow = sum("buffer overflow" in str(w.message) for w in rec)
        shipped = int(example["points_count"][0, 0])
        boxes, labels = dets[0]["box3d_lidar"], dets[0]["label_preds"]
        check(boxes.ndim == 2 and boxes.shape[1] == 7 and len(boxes) > 0
              and np.isfinite(boxes).all(), f"nusc frame {i}: bad boxes")
        check(overflow == 0 and shipped == in_range,
              f"nusc frame {i}: shipped {shipped} of {in_range} in-range "
              f"points, {overflow} overflow warnings")
        per_class = {names[c]: int((labels == c).sum())
                     for c in range(spec.num_class)}
        log(f"nusc frame {i} ({sensor['metadata']['token']}): "
            f"{len(points)} points of 10 sweeps, {shipped} shipped of "
            f"{ctx.route.points_capacity} ({in_range} in range; overflow "
            f"warnings "
            f"{overflow}), {len(boxes)} detections {per_class}, host prep "
            f"{(t1 - t0) * 1e3:.3f} ms, device inference "
            f"{(t2 - t1) * 1e3:.3f} ms, total {(t2 - t0) * 1e3:.3f} ms")
    launches = read_launches("nusc_mhead")
    if spec.use_rotate_nms:
        check(launches["rotated_iou"] > 0,
              "the nusc_mhead path never launched rotated_iou")
    log(f"nusc mhead: launches in the {N_FRAMES} requests: {launches}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def nusc_reference(ctx, dataset, device):
    """Frame 0: the flat pillar path's canvas and preds against the
    module path's (``voxelize`` -> the encoder -> the scatter -> the
    network) on the card; the card against the CPU (preds, detections
    matched as in phase 4); the CPU's NMS candidates through K4 (and K3
    where the NMS rotates) on the card keep exactly the CPU's boxes."""
    sensor = dataset.get_sensor_data(0)
    example = ctx.get_inference_input_dict(sensor["metadata"],
                                           sensor["lidar"]["points"])
    preds, dets = ctx.run(example)
    net = ctx.parts["net"]
    ex = example_to_device(example, device)
    pts, n, vs, rmin, grid, max_voxels, t = _pp_flat_inputs(ctx, ex)
    with torch.no_grad():
        flat = flat_pillarize(pts, n, vs, rmin, grid, max_voxels, t)
        bev_flat = flat_pfn_bev(net.voxel_feature_extractor, *flat[:5],
                                max_points_per_voxel=t, grid_size=grid)[None]
        voxels, coords, counts, nv = voxelize(pts, n, vs, rmin, grid,
                                              max_voxels, t)
        bev_mod = net.middle_feature_extractor(
            net.voxel_feature_extractor(voxels[None], counts[None],
                                        coords[None]), coords[None])
        preds_mod = net(voxels[None], counts[None], coords[None])
    err = (bev_flat - bev_mod).abs().max().item()
    check(torch.allclose(bev_flat, bev_mod, atol=PP_CANVAS_TOL,
                         rtol=PP_CANVAS_TOL),
          f"nusc: flat canvas vs module path max err {err}")
    rel = max(_route_rel(preds[k], preds_mod[k]) for k in preds)
    check(rel <= PREDS_REL_TOL,
          f"nusc: flat path preds vs module path rel err {rel}")
    log(f"nusc reference: flat path vs module path on the card, canvas "
        f"{tuple(bev_flat.shape)} of {int(nv)} pillars max err {err:.3e}, "
        f"preds rel err {rel:.3e}")
    cpu = InferenceContext()
    cpu.build(MHEAD_CONFIG, device="cpu")
    cpu.parts["net"].load_state_dict(net.state_dict())
    t0 = time.perf_counter()
    preds_cpu, dets_cpu = cpu.run(example)
    log(f"nusc reference: frame 0 on the CPU took "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    for key in preds:
        rel = _route_rel(preds[key].cpu(), preds_cpu[key])
        check(rel <= PREDS_REL_TOL,
              f"nusc {key}: card vs CPU rel err {rel} > {PREDS_REL_TOL}")
        log(f"nusc reference: {key} {tuple(preds_cpu[key].shape)} card vs "
            f"CPU rel err {rel:.3e}")
    frac, _, _ = _match(_ragged(dets), _ragged(dets_cpu))
    log(f"nusc reference: detections card {int(dets['valid'].sum())}, CPU "
        f"{int(dets_cpu['valid'].sum())}, matched {frac:.4f}")
    check(frac >= FRAME_MATCH_MIN,
          f"nusc detections matched {frac} < {FRAME_MATCH_MIN}")
    anchors = torch.from_numpy(example["anchors"].astype(np.float32))
    straddles, keep_diff = _nms_disagreement(
        ctx.parts["spec"], preds_cpu, anchors, device)
    check(straddles == 0 and keep_diff == 0,
          f"nusc: the CPU's candidates on the card: {straddles} IoU pairs "
          f"straddle the threshold, {keep_diff} keep flags differ")


def nusc_full_mean(dataset, device):
    """The device voxelizer (``make_voxelizer_fn``) of the mhead's
    generator with ``full_empty_part_with_mean`` set, on frame 0's
    in-range points on the card, against the host voxelizer: the same
    voxels (compared by coordinate), counts and slot values."""
    cfg = load_pipeline_config(MHEAD_CONFIG)
    cfg.model.second.voxel_generator.full_empty_part_with_mean = True
    gen = voxel_builder.build(cfg.model.second.voxel_generator)
    max_voxels = cfg.eval_input_reader.preprocess.max_number_of_voxels
    points = dataset.get_sensor_data(0)["lidar"]["points"]
    host = gen.generate_multi_gpu(points, max_voxels)
    buf, count = pad_points(points, gen.point_cloud_range,
                            points_capacity(cfg.eval_input_reader))
    voxels, counts, coords = (t[0].cpu().numpy() for t in make_voxelizer_fn(
        gen, max_voxels)(torch.from_numpy(buf[None]).to(device),
                         torch.tensor([[count]], dtype=torch.int32,
                                      device=device)))

    def by_coords(c, *arrays):
        keep = c[:, 0] >= 0
        order = np.lexsort(c[keep].T[::-1])
        return [a[keep][order] for a in (c,) + arrays]

    nv = int(host["voxel_num"])
    hc, hn, hv = by_coords(host["coordinates"][:nv],
                           host["num_points_per_voxel"][:nv],
                           host["voxels"][:nv])
    c, cn, v = by_coords(coords, counts, voxels)
    check(np.array_equal(c, hc) and np.array_equal(cn, hn),
          f"full_mean: device voxels {len(c)} vs host {len(hc)} differ in "
          f"coordinates or counts")
    err = float(np.abs(v - hv).max())
    filled = int(((np.arange(v.shape[1])[None] >= cn[:, None])
                  & (cn[:, None] > 0)).sum())
    check(err <= 1e-5, f"full_mean: device voxels vs host max err {err}")
    log(f"nusc full_mean: the device voxelizer on frame 0 ({count} points, "
        f"{nv} voxels, {filled} empty slots filled with their voxel's "
        f"mean) against the host voxelizer: coordinates and counts equal, "
        f"values max err {err:.3e}")


def phase_nusc_mhead(device, work):
    """Phase 14: the nuScenes multi-head PointPillars through the port's
    entry points on a fixture tree at nuScenes density. Returns the
    kernel launches of its requests, train() and evaluate() runs."""
    t_phase = time.perf_counter()
    work.mkdir()
    root = work / "nusc"
    t0 = time.perf_counter()
    info_path = build_nusc_dir(root, num_frames=NUSC_FRAMES)
    dataset = NuScenesDataset(root, info_path)
    log(f"nusc fixture tree: {NUSC_FRAMES} frames of a key frame and 9 "
        f"sweeps ({dataset.get_sensor_data(0)['lidar']['points'].shape[0]}"
        f" points each) in {time.perf_counter() - t0:.3f} s")
    ctx = _f32_ctx(MHEAD_CONFIG, device)
    spec = ctx.parts["spec"]
    log(f"nusc mhead: {type(ctx.parts['net']).__name__}, "
        f"{spec.num_class} classes {ctx.parts['target_assigner'].classes}, "
        f"{ctx.parts['anchor_cache']['anchors'].shape[0]} anchors, flat "
        f"pillar path {ctx.route.flat_pp}, points capacity "
        f"{ctx.route.points_capacity},"
        f" {'rotated' if spec.use_rotate_nms else 'standup'} NMS")
    launches = nusc_requests(ctx, dataset)
    nusc_reference(ctx, dataset, device)

    t0 = time.perf_counter()
    create_groundtruth_database("NuScenesDataset", str(root),
                                str(info_path))
    with open(root / "kitti_dbinfos_train.pkl", "rb") as f:
        db = {k: len(v) for k, v in pickle.load(f).items()}
    log(f"nusc GT database: {db} objects in "
        f"{time.perf_counter() - t0:.3f} s")
    config = nusc_config(root, work / "mhead.config", NUSC_TRAIN_STEPS)
    total = NUSC_TRAIN_STEPS + NUSC_RESUME_STEPS
    fhd_step_checks(config, root, device, device_route=True,
                    label="nusc mhead", dataset=NuScenesDataset(
                        root, info_path))
    train_launches = fhd_train_runs(
        config, root, work, device, "nusc_mhead", NUSC_TRAIN_STEPS,
        NUSC_RESUME_STEPS, base_config=MHEAD_CONFIG, frames=NUSC_FRAMES,
        resume_config=nusc_config(root, work / "mhead_resume.config", total),
        metric="kitti.official")
    launches = {k: launches[k] + train_launches[k] for k in launches}
    for kernel in PATH_KERNELS["nusc_mhead"]:
        check(launches[kernel] > 0,
              f"the nusc_mhead path never launched {kernel}")
    log(f"nusc mhead: launches in the requests, train() and evaluate() "
        f"runs: {launches}")
    nusc_full_mean(dataset, device)
    log(f"phase 14 (nusc_mhead): {time.perf_counter() - t_phase:.3f} s")
    return launches


def phase_nusc_res8x(device):
    """Phase 14b: the nuScenes residual sparse SECOND
    (``configs/nuscenes/all.res8x.config``) at its published grid and
    widths, one generator frame through ``InferenceContext``. Returns
    the kernel launches of its request and K1's numbers at 128 channels
    on that request's own features and rulebooks."""
    t_phase = time.perf_counter()
    ctx = _f32_ctx(RES8X_CONFIG, device)
    mid = ctx.parts["net"].middle_feature_extractor
    check(type(mid).__name__ == "SpMiddleResNetFHD"
          and ctx.route.sort_shape is not None and not ctx.route.ships_points,
          f"nusc res8x: {type(mid).__name__} off the voxel route")
    points = nusc_scenes.make_frame(np.random.default_rng([23, 1, 0]),
                                    34720, 5)[0]
    names = ctx.parts["target_assigner"].classes
    # the first request builds the kernels
    ctx.inference(ctx.get_inference_input_dict({"token": "warm"}, points))
    wide, plain, conv3d = [], [], []
    inner_gemm = sparse_ops.gather_gemm
    inner_plain = cuda_sparse_conv.gather_gemm_plain
    inner_3d = torch.nn.functional.conv3d

    def gemm(feat, slots, weight, bias=None):
        if weight.shape[-1] > cuda_sparse_conv.NARROW_MAX:
            wide.append([t.detach().clone() if t is not None else None
                         for t in (feat, slots, weight, bias)])
        return inner_gemm(feat, slots, weight, bias)

    sparse_ops.gather_gemm = gemm
    cuda_sparse_conv.gather_gemm_plain = (
        lambda *a, **k: plain.append(1) or inner_plain(*a, **k))
    torch.nn.functional.conv3d = (
        lambda *a, **k: conv3d.append(1) or inner_3d(*a, **k))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            example = ctx.get_inference_input_dict({"token": "res8x"},
                                                   points)
        t1 = time.perf_counter()
        reset_launches()
        dets = ctx.inference(example)[0]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_launches("nusc_res8x")
    finally:
        sparse_ops.gather_gemm = inner_gemm
        cuda_sparse_conv.gather_gemm_plain = inner_plain
        torch.nn.functional.conv3d = inner_3d
    k1 = launches["sparse_conv_gather_gemm"]
    check(k1 == RES8X_SPARSE_CONVS,
          f"nusc res8x: {k1} K1 launches a request, not "
          f"{RES8X_SPARSE_CONVS}")
    check(len(wide) == RES8X_WIDE_CONVS,
          f"nusc res8x: {len(wide)} convs above 64 channels, not "
          f"{RES8X_WIDE_CONVS}")
    check(not plain and not conv3d,
          f"nusc res8x: {len(plain)} plain gathers, {len(conv3d)} conv3d")
    check(not rec, f"nusc res8x: warnings {[str(w.message) for w in rec]}")
    boxes, labels = dets["box3d_lidar"], dets["label_preds"]
    check(boxes.ndim == 2 and boxes.shape[1] == 7 and len(boxes) > 0
          and np.isfinite(boxes).all(), "nusc res8x: bad boxes")
    per_class = {names[c]: int((labels == c).sum())
                 for c in range(len(names))}
    log(f"nusc res8x: {len(points)} points of 10 sweeps, "
        f"{int(example['num_voxels'][0])} voxels, "
        f"{ctx.parts['anchor_cache']['anchors'].shape[0]} anchors; "
        f"{len(boxes)} detections {per_class}; launches {launches}; host "
        f"prep {(t1 - t0) * 1e3:.3f} ms, device inference "
        f"{(t2 - t1) * 1e3:.3f} ms")

    errs, k_ms, d_ms, p_ms, b_ms, t_ms = [], 0.0, 0.0, 0.0, {}, 0.0
    for i, (feat, slots, w, bias) in enumerate(wide):
        b, vin, cin = feat.shape
        k, _, cout = w.shape
        out = cuda_sparse_conv.gather_gemm(feat, slots, w, bias)
        ref = cuda_sparse_conv.gather_gemm_plain(feat, slots, w, bias)
        err = (out - ref).abs().max().item()
        tol = K1_TOL * max(1.0, ref.abs().max().item())
        check(err <= tol, f"K1 wide conv {i}: max err {err} > {tol}")
        check(torch.equal(out, cuda_sparse_conv.gather_gemm(
            feat, slots, w, bias)), f"K1 wide conv {i}: two calls differ")
        cb, co = gather_conv_bound(b, vin, cin, slots, cout, False)
        cms, cby = bound_ms(cb, co)
        tms = tf32x3_bound_ms(cb, co)
        kms = cuda_ms(lambda: cuda_sparse_conv.gather_gemm(
            feat, slots, w, bias))
        dms = graph_ms(lambda: cuda_sparse_conv.gather_gemm(
            feat, slots, w, bias))
        pms = cuda_ms(lambda: cuda_sparse_conv.gather_gemm_plain(
            feat, slots, w, bias), iters=5, warmup=1)
        errs.append(err)
        k_ms += kms
        d_ms += dms
        p_ms += pms
        b_ms[cby] = b_ms.get(cby, 0.0) + cms
        t_ms += tms
        log(f"K1 wide conv {i}: rows ({vin}, {cin}) -> "
            f"{tuple(slots.shape[1:])} x {cout}, max err {err:.3e} "
            f"(tolerance {tol:.3e}), two calls bitwise equal, kernel "
            f"{kms:.4f} ms (device {dms:.4f}), plain {pms:.4f} ms, bound "
            f"fp32 {cms:.4f} ms ({cby}) / 3xTF32 {tms:.4f} ms; "
            f"{co / 1e9:.3f} GFLOP of hits at {co / kms / 1e9:.3f} "
            f"TFLOP/s; {skips(tile_stats(slots, vin))}")
    results = {"convs": len(wide), "max_abs_err": max(errs), "ms": k_ms,
               "device_ms": d_ms, "plain_ms": p_ms,
               "bound_ms": sum(b_ms.values()),
               "bound_by": max(b_ms, key=b_ms.get),
               "bound_tf32x3_ms": t_ms}
    log(f"K1 at 128 channels, the request's {len(wide)} convs: kernel "
        f"{k_ms:.4f} ms (device {d_ms:.4f}), plain {p_ms:.4f} ms, bound "
        f"fp32 {results['bound_ms']:.4f} ms / 3xTF32 {t_ms:.4f} ms "
        f"({card_name()})")
    log(f"phase 14b (nusc_res8x): {time.perf_counter() - t_phase:.3f} s")
    return launches, results


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def finetune_config(root, path, steps, optimizer_text):
    """``fixture_config`` of car.fhd with the optimizer ``optimizer_text``
    (an ``optimizer`` message's fields)."""
    cfg = load_pipeline_config(fixture_config(CONFIG, root, path, steps))
    cfg.train_config.optimizer = schema.Optimizer.from_raw(
        parse_text(optimizer_text))
    path.write_text(cfg.to_text())
    return str(path)


def _add_launches(total):
    """Add the launches since :func:`reset_launches` into ``total``."""
    for name, module, _, _ in KERNELS:
        total[name] = total.get(name, 0) + module.launches


def _frame(root, i=0):
    """The fixture tree's val frame ``i``: its info and points."""
    dataset = KittiDataset(root, root / "kitti_infos_val.pkl")
    with open(root / "kitti_infos_val.pkl", "rb") as f:
        info = pickle.load(f)[i]
    return info, dataset.get_sensor_data(i)["lidar"]["points"]


def _ctx_with(config, device, weights):
    ctx = InferenceContext()
    ctx.build(config, device=device)
    ctx.parts["net"].load_state_dict(weights)
    return ctx


def _differs(a, b):
    """Whether two ragged detection sets differ (count, box or score)."""
    return (len(a["scores"]) != len(b["scores"])
            or not np.array_equal(a["scores"], b["scores"])
            or not np.array_equal(a["box3d_lidar"], b["box3d_lidar"]))


def finetune_import(config, work, device, launches):
    """Step 1: an upstream .tckpt of car.fhd (seed 0) through
    ``import_tckpt``; frame 0 of ``make_kitti_scene`` from the imported
    checkpoint on the card against the CPU. Returns the checkpoint's
    path."""
    t0 = time.perf_counter()
    sd = write_tckpt(config, work / "voxelnet-0.tckpt", seed=0)
    report = import_tckpt(config, str(work / "voxelnet-0.tckpt"),
                          str(work / "imported"), device=device)
    check(not report["missing_targets"],
          f"import: missing targets {report['missing_targets']}")
    path = work / "imported" / "voxelnet-0.ckpt"
    log(f"finetune import: {len(sd)} upstream tensors, assigned "
        f"{len(report['assigned'])}, skipped "
        f"{len(report['skipped_torch_keys'])}"
        f" (num_batches_tracked, global_step), missing 0, in "
        f"{time.perf_counter() - t0:.3f} s")
    ctx = InferenceContext()
    ctx.build(CONFIG, device=device)
    reset_launches()
    check(ctx.restore_latest(str(work / "imported")) == 0,
          "import: no checkpoint at step 0")
    example = ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(0))[0])
    preds, dets = ctx.run(example)
    torch.cuda.synchronize()
    _add_launches(launches)
    cpu = InferenceContext()
    cpu.build(CONFIG, device="cpu")
    cpu.restore(str(path))
    preds_cpu, dets_cpu = cpu.run(example)
    for key in preds:
        ref = preds_cpu[key]
        rel = ((preds[key].cpu() - ref).abs().max()
               / ref.abs().max().clamp(min=1e-12)).item()
        check(rel <= PREDS_REL_TOL,
              f"import {key}: card vs CPU rel err {rel} > {PREDS_REL_TOL}")
        log(f"finetune import: frame 0 {key} card vs CPU rel err {rel:.3e}")
    frac, _, _ = _match(_ragged(dets), _ragged(dets_cpu))
    log(f"finetune import: detections card {int(dets['valid'].sum())}, CPU "
        f"{int(dets_cpu['valid'].sum())}, matched {frac:.4f}")
    check(frac >= FRAME_MATCH_MIN,
          f"import: detections matched {frac} < {FRAME_MATCH_MIN}")
    return path


def _trace_kernels(trace):
    """The names of the card's kernels in a Chrome trace."""
    events = json.loads(Path(trace).read_text())["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def finetune_run_a(root, work, device, launches, card):
    """Step 2: run A, the momentum optimizer with the one-cycle momentum
    and the EMA, a profile of 2 steps, then ``evaluate()``, which must
    run on the EMA. Returns (config, model dir, median step ms)."""
    config = finetune_config(root, work / "a.config", FT_STEPS_A,
                             FT_OPTIMIZER_A)
    model = work / "model_a"
    reset_launches()
    np.random.seed(0)
    t0 = time.perf_counter()
    train(config, str(model), display_step=1, measure_time=True,
          profile_steps=FT_PROFILE_STEPS, device=device)
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    res = evaluate(config, str(model), result_path=str(work / "eval_a"),
                   batch_size=1, device=device)
    wall_eval = time.perf_counter() - t1
    _add_launches(launches)
    run = {name: module.launches for name, module, _, _ in KERNELS}
    for name in PATH_KERNELS["finetune"]:
        check(run[name] > 0, f"run A never launched {name}")
    losses, step_ms, fetch_ms, evals, text = _log_steps(model)
    loss = [losses[i] for i in range(1, FT_STEPS_A + 1)]
    check(all(np.isfinite(loss)), f"run A: non-finite loss {loss}")
    trace = model / "profile" / "trace.json"
    check(trace.is_file() and "profiler trace written" in text,
          "run A: no profiler trace")
    names = _trace_kernels(trace)
    k1 = sorted(n for n in names if K1_TRACE_NAME in n)
    k2 = sorted(n for n in names if K2_TRACE_NAME in n)
    check(k1 and k2, f"run A's trace names no K1 ({k1}) or K2 ({k2})")
    check("official" in res["results"], "run A evaluate: no official AP")
    median = statistics.median(step_ms[i] for i in range(2, FT_STEPS_A + 1))
    batch = load_pipeline_config(config).train_input_reader.batch_size
    log(f"finetune run A ({card}): momentum + one-cycle momentum + EMA, "
        f"{FT_STEPS_A} steps at batch {batch} with the sampler, losses "
        f"{[round(v, 6) for v in loss]}, step ms median of steps "
        f"2-{FT_STEPS_A} {median:.3f} (all: "
        f"{[round(step_ms[i], 3) for i in sorted(step_ms)]}; steps 2-"
        f"{1 + FT_PROFILE_STEPS} under the profiler), data-fetch ms median "
        f"{statistics.median(fetch_ms.values()):.3f}, train() wall "
        f"{wall:.3f} s, evaluate() wall {wall_eval:.3f} s, {evals[-1]}")
    log(f"finetune run A: trace {trace} ({trace.stat().st_size} bytes, "
        f"{len(names)} kernel names), K1 {k1[:1]}, K2 {k2[:1]}; launches "
        f"{run}")

    payload = torch.load(model / f"voxelnet-{FT_STEPS_A}.ckpt",
                         map_location="cpu", weights_only=True)
    live = _ctx_with(config, device, payload["net"])
    ema = dict(payload["net"])
    ema.update(zip((n for n, _ in live.parts["net"].named_parameters()),
                   payload["optimizer"]["ema"]))
    on_ema = _ctx_with(config, device, ema)
    info, points = _frame(root)
    with open(work / "eval_a" / "result.pkl", "rb") as f:
        evaluated = pickle.load(f)[0]
    ema_dets = on_ema.inference(on_ema.get_inference_input_dict(
        info, points))[0]
    live_dets = live.inference(live.get_inference_input_dict(
        info, points))[0]
    frac, _, _ = _match(evaluated, ema_dets)
    log(f"finetune run A: evaluate()'s frame 0 against the EMA's weights "
        f"alone: {len(evaluated['scores'])} vs {len(ema_dets['scores'])} "
        f"detections, matched {frac:.4f}, identical "
        f"{not _differs(evaluated, ema_dets)}; against the live weights "
        f"{len(live_dets['scores'])} detections, identical "
        f"{not _differs(evaluated, live_dets)}")
    check(frac >= FRAME_MATCH_MIN and len(evaluated["scores"])
          == len(ema_dets["scores"]), "run A: evaluate() not on the EMA")
    check(_differs(evaluated, live_dets) and _differs(ema_dets, live_dets),
          "run A: the EMA's detections equal the live weights'")
    return config, model, median


def finetune_run_b(root, work, device, launches, imported, card):
    """Step 3: run B, RMSProp from the imported checkpoint with the
    sparse middle frozen: no K2 and no input gradient of K1; returns the
    median step ms."""
    config = finetune_config(root, work / "b.config", FT_STEPS_B,
                             FT_OPTIMIZER_B)
    model = work / "model_b"
    reset_launches()
    np.random.seed(0)
    t0 = time.perf_counter()
    train(config, str(model), display_step=1, measure_time=True,
          pretrained_path=str(imported), freeze_include=FT_FREEZE,
          device=device)
    wall = time.perf_counter() - t0
    _add_launches(launches)
    run = {name: module.launches for name, module, _, _ in KERNELS}
    batch = load_pipeline_config(config).train_input_reader.batch_size
    eval_batches = -(-FHD_FRAMES // batch)
    forward = (FT_STEPS_B + eval_batches) * len(SPARSE_CONVS)
    check(run["sparse_conv_weight_grad"] == 0,
          f"run B launched K2 {run['sparse_conv_weight_grad']} times")
    check(run["sparse_conv_gather_gemm"] == forward,
          f"run B launched K1 {run['sparse_conv_gather_gemm']} times, not "
          f"the {forward} forward convs (an input gradient ran)")
    losses, step_ms, _, evals, _ = _log_steps(model)
    loss = [losses[i] for i in range(1, FT_STEPS_B + 1)]
    check(all(np.isfinite(loss)), f"run B: non-finite loss {loss}")
    pre = torch.load(imported, map_location="cpu", weights_only=True)["net"]
    after = torch.load(model / f"voxelnet-{FT_STEPS_B}.ckpt",
                       map_location="cpu", weights_only=True)
    frozen = after["optimizer"]["frozen"]
    same = [n for n in frozen if torch.equal(after["net"][n], pre[n])]
    rpn = [n for n in after["net"] if n.startswith("rpn.")]
    moved = [n for n in rpn if not torch.equal(after["net"][n], pre[n])]
    check(frozen and all(n.startswith("middle_feature_extractor.")
                         for n in frozen), f"run B froze {frozen}")
    check(len(same) == len(frozen),
          f"run B: {len(frozen) - len(same)} frozen tensors changed")
    check(rpn and len(moved) == len(rpn),
          f"run B: {len(rpn) - len(moved)} RPN tensors did not change")
    median = statistics.median(step_ms[i] for i in range(2, FT_STEPS_B + 1))
    log(f"finetune run B ({card}): RMSProp from the imported checkpoint, "
        f"{len(frozen)} middle tensors frozen ({FT_FREEZE}), "
        f"{FT_STEPS_B} steps, losses {[round(v, 6) for v in loss]}, step "
        f"ms median of steps 2-{FT_STEPS_B} {median:.3f} (all: "
        f"{[round(step_ms[i], 3) for i in sorted(step_ms)]}), train() "
        f"wall {wall:.3f} s, {evals[-1]}; frozen tensors bitwise equal "
        f"{len(same)}/{len(frozen)}, RPN tensors changed "
        f"{len(moved)}/{len(rpn)}; launches {run} (K1 = {forward} forward "
        f"convs only, K2 0)")
    return median


def finetune_tools(config, model, work, device, launches, card):
    """Step 4: ``helper_tune_target_assigner`` for one epoch, and
    ``script.eval_multi_threshold`` of run A's checkpoint."""
    np.random.seed(0)
    t0 = time.perf_counter()
    gt, assigned = helper_tune_target_assigner(config, num_tune_epoch=1)
    log(f"finetune helper_tune_target_assigner: gt {gt}, assigned anchors "
        f"{assigned} in {time.perf_counter() - t0:.3f} s")
    check(gt["Car"] > 0 and assigned["Car"] > 0,
          "helper_tune_target_assigner: no car or no anchor assigned")
    reset_launches()
    t0 = time.perf_counter()
    res = script.eval_multi_threshold(config, str(model),
                                      score_thresholds=FT_THRESHOLDS,
                                      device=device)
    wall = time.perf_counter() - t0
    _add_launches(launches)
    counts = []
    for thr in FT_THRESHOLDS:
        check("official" in res[thr]["results"],
              f"eval_multi_threshold {thr}: no official AP")
        with open(model / f"eval_thr{thr}" / "result.pkl", "rb") as f:
            counts.append(sum(len(d["scores"]) for d in pickle.load(f)))
    log(f"finetune script.eval_multi_threshold ({card}): thresholds "
        f"{FT_THRESHOLDS}, detections {counts}, wall {wall:.3f} s")
    check(all(a >= b for a, b in zip(counts, counts[1:])),
          f"eval_multi_threshold: detections rose with the threshold "
          f"{counts}")


def _viewer_post(port, route, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        res = json.loads(resp.read())["results"][0]
    check(res["status"] == "normal", f"viewer {route}: {res}")
    return res


def finetune_viewer(root, config, model, device, launches, card):
    """Step 5: the viewer backend on 127.0.0.1 (a free port) with run A's
    checkpoint: each request's detections equal ``InferenceContext``'s
    on the same frame."""
    server = viewer.make_server(0, "127.0.0.1", device=str(device))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    ckpt = ckpt_lib.latest_checkpoint(model, "voxelnet")
    try:
        res = _viewer_post(port, "/api/readinfo", {
            "root_path": str(root),
            "info_path": str(root / "kitti_infos_val.pkl")})
        check(len(res["image_indexes"]) == FHD_FRAMES,
              f"viewer readinfo: {res['image_indexes']}")
        _viewer_post(port, "/api/build_network",
                     {"config_path": config, "checkpoint_path": ckpt})
        reset_launches()
        answers, ms = [], []
        for idx in range(FT_VIEWER_FRAMES):
            t0 = time.perf_counter()
            answers.append(_viewer_post(port, "/api/inference_by_idx",
                                        {"image_idx": idx}))
            ms.append((time.perf_counter() - t0) * 1e3)
        _add_launches(launches)
        run = {name: module.launches for name, module, _, _ in KERNELS}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "viewer: the server thread did not stop")
    check(run["rotated_iou"] > 0 and run["greedy_nms"] > 0,
          f"viewer: K3/K4 not launched {run}")
    ctx = InferenceContext()
    ctx.build(config, device=device)
    ctx.restore(ckpt)
    for idx, answer in enumerate(answers):
        info, points = _frame(root, idx)
        ref = ctx.inference(ctx.get_inference_input_dict(info, points))[0]
        rots = np.asarray(answer["dt_rots"]).reshape(-1, 3)
        got = {"box3d_lidar": np.concatenate(
            [np.asarray(answer["dt_locs"]).reshape(-1, 3),
             np.asarray(answer["dt_dims"]).reshape(-1, 3),
             -rots[:, 2:3]], 1).astype(np.float32),
            "scores": np.asarray(answer["dt_scores"], np.float32)}
        frac, _, _ = _match(got, ref)
        check(frac == 1.0 and len(got["scores"]) == len(ref["scores"])
              and answer["dt_labels"] == ref["label_preds"].tolist(),
              f"viewer frame {idx}: detections matched {frac}")
        log(f"finetune viewer frame {idx} ({card}): {len(got['scores'])} "
            f"detections, matched InferenceContext {frac:.4f}, request "
            f"{ms[idx]:.3f} ms end to end")
    log(f"finetune viewer: launches in the requests {run}")


def phase_finetune(device, work, root):
    """Phase 15: car.fhd fine-tuning from an upstream checkpoint on phase
    10's fixture tree at ``root``: the import, run A (momentum, EMA,
    profile), run B (RMSProp, pretrained, middle frozen), the tools and
    the viewer. Returns the kernel launches of those runs."""
    work.mkdir()
    card = card_name()
    t0 = time.perf_counter()
    launches = {}
    config = fixture_config(CONFIG, root, work / "fhd.config",
                            FT_STEPS_A)
    imported = finetune_import(config, work, device, launches)
    config_a, model_a, ms_a = finetune_run_a(root, work, device, launches,
                                             card)
    ms_b = finetune_run_b(root, work, device, launches, imported, card)
    log(f"finetune ({card}): median step ms run A {ms_a:.3f} (whole "
        f"network trained) vs run B {ms_b:.3f} (middle frozen: no K2, no "
        f"input gradient through it)")
    finetune_tools(config_a, model_a, work, device, launches, card)
    finetune_viewer(root, config_a, model_a, device, launches, card)
    for name in PATH_KERNELS["finetune"]:
        check(launches[name] > 0, f"the finetune path never launched {name}")
    log(f"finetune: launches {launches}; phase wall "
        f"{time.perf_counter() - t0:.3f} s ({card})")
    return launches


def by_name(counts):
    """A process's kernel launches (``ops.launch_counts``, by each
    wrapper's ``KERNEL``) by this script's kernel names."""
    return {name: counts[module.KERNEL] for name, module, _, _ in KERNELS}


def _add(total, counts):
    for name, n in by_name(counts).items():
        total[name] += n


def _rel_l2(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _grad_errors(grads, ref):
    """Each gradient's L2 distance from ``ref``'s over the L2 norm of
    ``ref``'s, or for a batch norm's bias over the larger of its own and
    its scale's: where the next norm removes a per-channel shift, the
    bias's gradient is a nearly cancelling sum that fp32 resolves only
    to its scale's size (``tests/test_torch_train.py``
    ``UNRESOLVED_GRADS``: rpn.layers.2.bn.bias, 60 times smaller than
    its scale's)."""
    out = {}
    for name, g in grads.items():
        scale = float(ref[name].norm())
        if ".bn" in name and name.endswith(".bias"):
            scale = max(scale, float(ref[name[:-4] + "weight"].norm()))
        out[name] = float((g - ref[name]).norm()) / max(scale, 1e-30)
    return out


def _open_relus(net, seed):
    """Every batch norm's bias drawn in [5, 6] and scale in [0.5, 1], and
    the heads' kernels scaled by 0.05, as the CPU training parity tests
    draw them (``tests/test_torch_train.py`` ``train_variables``,
    ``test_torch_pp_train.pp_train_variables``): every ReLU input then
    sits units clear of zero, so two fp32 programs that sum in other
    orders take the same gates and fp32 resolves the gradients."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, MaskedBatchNorm):
                for t, lo, hi in ((module.bias, 5.0, 6.0),
                                  (module.weight, 0.5, 1.0)):
                    t.copy_(torch.from_numpy(
                        rng.uniform(lo, hi, t.shape).astype(np.float32)))
        for name, p in net.rpn.named_parameters():
            if name.startswith(("conv_cls", "conv_box", "conv_dir_cls")) \
                    and name.endswith("weight"):
                p.mul_(0.05)


def ddp_inputs(device, work):
    """Phase 7's batch of 8 ``make_kitti_scene`` frames (host arrays),
    car.fhd's config without the sampler and its random weights (seed
    0, the ReLUs opened: :func:`_open_relus`), written under ``work`` for
    the ranks."""
    cfg = without_sampler(load_pipeline_config(CONFIG))
    config = work / "fhd_nosampler.config"
    config.write_text(cfg.to_text())
    parts = build_network(cfg, device)
    init_weights(parts["net"], torch.Generator().manual_seed(0))
    _open_relus(parts["net"], 0)
    host = example_convert(prepare_train_batch(build_prep_func(
        cfg.train_input_reader, parts, training=True)))
    weights = {k: v.cpu() for k, v in parts["net"].state_dict().items()}
    with open(work / "batch.pkl", "wb") as f:
        pickle.dump(host, f)
    torch.save(weights, work / "weights.pt")
    return cfg, host, weights, (str(config), str(work / "batch.pkl"),
                                str(work / "weights.pt"))


def _ungrouped_step(cfg, weights, host, device, rows=slice(None)):
    """``dryrun.step_outputs`` in this process (no group) on ``rows`` of
    the host batch, from ``weights``."""
    parts = build_network(cfg, device)
    parts["net"].load_state_dict(weights)
    ex = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
          for k, v in host.items()}
    out = dryrun.step_outputs(parts["net"], parts["spec"], cfg, ex)
    out["state"] = {k: v.cpu() for k, v in parts["net"].state_dict().items()}
    return out


def ddp_step_parity(device, work, inputs, launches, card):
    """Phase 16 (a): the sharded step of DDP_RANKS gloo ranks on cuda:0,
    TRAIN_BATCH / DDP_RANKS frames each, against one process's step on
    the 8 frames from the same weights; the ranks bitwise equal; the
    negative control (each shard alone, gradients averaged by hand)."""
    cfg, host, weights, paths = inputs
    single = _ungrouped_step(cfg, weights, host, device)
    again = _ungrouped_step(cfg, weights, host, device)
    noise = max(_grad_errors(again["grads"], single["grads"]).values())
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh.run_ranks(dryrun.step_rank, DDP_RANKS, args=(
        str(device), "gloo", *paths, str(work / "step")),
        timeout=DDP_TIMEOUT)
    wall = time.perf_counter() - t0
    outs = [torch.load(r["path"], weights_only=False) for r in ranks]
    for r in ranks:
        _add(launches, r["launches"])
    for key in ("grads", "state"):
        differ = [n for n, v in outs[0][key].items()
                  if not torch.equal(v, outs[1][key][n])]
        check(not differ, f"ddp step: the ranks' {key} differ: {differ}")
    loss, ref = outs[0]["metrics"]["loss"], single["metrics"]["loss"]
    loss_rel = abs(loss - ref) / abs(ref)
    grad_rel = _grad_errors(outs[0]["grads"], single["grads"])
    worst = max(grad_rel, key=grad_rel.get)
    log("ddp (a) largest gradient errors: " + ", ".join(
        f"{n} {grad_rel[n]:.3e}" for n in sorted(
            grad_rel, key=grad_rel.get, reverse=True)[:8]))
    alone = [_ungrouped_step(cfg, weights, host, device, shard)
             for shard in (slice(0, TRAIN_BATCH // 2),
                           slice(TRAIN_BATCH // 2, TRAIN_BATCH))]
    averaged = {n: (g + alone[1]["grads"][n]) / 2
                for n, g in alone[0]["grads"].items()}
    control = {n: e for n, e in _grad_errors(
        averaged, single["grads"]).items() if ".bn" in n}
    outside = sum(v > 10 * DDP_GRAD_REL_TOL for v in control.values())
    stats_rel = max(_rel_l2(v, single["state"][n])
                    for n, v in outs[0]["state"].items() if "running" in n)
    log(f"ddp (a) sharded step ({card}): {DDP_RANKS} gloo ranks sharing "
        f"cuda:0 at batch {TRAIN_BATCH // DDP_RANKS} each against one "
        f"process at batch {TRAIN_BATCH}: loss {loss:.6f} vs {ref:.6f} "
        f"(rel {loss_rel:.3e}, limit {DDP_LOSS_REL_TOL}); num_pos "
        f"{outs[0]['metrics']['num_pos']:.0f} vs "
        f"{single['metrics']['num_pos']:.0f}; largest gradient error "
        f"{grad_rel[worst]:.3e} relative L2 (a norm's bias over its "
        f"scale's; {worst}; limit "
        f"{DDP_GRAD_REL_TOL}; the same step twice in one process: "
        f"{noise:.3e}); running statistics after the step "
        f"{stats_rel:.3e}; the ranks' gradients, parameters and running "
        f"statistics bitwise equal; negative control (each shard alone, "
        f"gradients averaged) on the {len(control)} batch-norm tensors: "
        f"{outside} outside 10x the limit, median "
        f"{statistics.median(control.values()):.3e}, largest "
        f"{max(control.values()):.3e}; step ms: one process "
        f"{single['ms']:.3f}, ranks {[round(r['ms'], 3) for r in ranks]} "
        f"(two processes sharing one card, gloo's all-reduce through host "
        f"memory: not a two-card number); ranks' wall {wall:.3f} s")
    check(loss_rel <= DDP_LOSS_REL_TOL,
          f"ddp step: loss {loss} vs {ref} (rel {loss_rel})")
    check(grad_rel[worst] <= DDP_GRAD_REL_TOL,
          f"ddp step: gradient {worst} off by {grad_rel[worst]}")
    check(outside > len(control) // 2,
          f"ddp step: the unsynced control sits inside 10x the limit on "
          f"{len(control) - outside} of {len(control)} batch norms")
    return single


def _dets_of(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def ddp_entry_points(device, work, root, launches, card):
    """Phase 16 (b): train() over DDP_RANKS gloo ranks on cuda:0 with
    the sampler on phase 10's tree, DDP_TRAIN_STEPS steps and
    DDP_RESUME_STEPS resumed, then evaluate() over the ranks against one
    process's evaluate() of the same checkpoint; one log, one set of
    checkpoints."""
    steps = DDP_TRAIN_STEPS + DDP_RESUME_STEPS
    config = fixture_config(CONFIG, root, work / "ddp.config",
                            DDP_TRAIN_STEPS)
    resume = fixture_config(CONFIG, root, work / "ddp_resume.config", steps)
    model_dir = work / "model_ddp"
    kwargs = dict(model_dir=str(model_dir), display_step=1,
                  measure_time=True)
    calls = [("train", dict(config_path=config, **kwargs)),
             ("train", dict(config_path=resume, resume=True, **kwargs)),
             ("evaluate", dict(config_path=config, model_dir=str(model_dir),
                               result_path=str(work / "eval_ddp")))]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = mesh.run_ranks(dryrun.entry_rank, DDP_RANKS, args=(
        str(device), "gloo", calls), timeout=DDP_TIMEOUT)
    wall = time.perf_counter() - t0
    for out in outs:
        _add(launches, out[-1]["launches"])
    losses, step_ms, fetch_ms, evals, text = _log_steps(model_dir)
    check(sorted(losses) == list(range(1, steps + 1)),
          f"ddp train: logged steps {sorted(losses)}: not one log")
    check(all(np.isfinite(list(losses.values()))),
          f"ddp train: non-finite loss {losses}")
    check(text.count(f"ranks={DDP_RANKS}") == 2,
          "ddp train: the log does not name the ranks")
    info = json.loads((model_dir / "checkpoints.json").read_text())
    check(info["all_ckpts"]["voxelnet"] == [
        f"voxelnet-{DDP_TRAIN_STEPS}.ckpt", f"voxelnet-{steps}.ckpt"],
        f"ddp train: checkpoints {info['all_ckpts']}")
    sharded = outs[0][-1]["result"]
    check(outs[1][-1]["result"] is None, "ddp evaluate: rank 1 returned a "
          "result")
    # one process at a rank's batch: the same frames through the same
    # batched programs
    rank_batch = (load_pipeline_config(config).eval_input_reader.batch_size
                  // DDP_RANKS)
    t1 = time.perf_counter()
    single = evaluate(config, str(model_dir), batch_size=rank_batch,
                      result_path=str(work / "eval_one"), device=device)
    single_wall = time.perf_counter() - t1
    dets = [_dets_of(work / d / "result.pkl")
            for d in ("eval_ddp", "eval_one")]
    check(len(dets[0]) == len(dets[1]) == FHD_FRAMES,
          f"ddp evaluate: {len(dets[0])} and {len(dets[1])} frames")
    check([a["metadata"]["image_idx"] for a in dets[0]]
          == [b["metadata"]["image_idx"] for b in dets[1]],
          "ddp evaluate: frames out of order")
    counts = [[len(a["scores"]) for a in d] for d in dets]
    check(counts[0] == counts[1],
          f"ddp evaluate: detections per frame {counts[0]} over the ranks, "
          f"{counts[1]} in one process")
    err = max((float(np.abs(a[key].astype(np.float64) - b[key]).max())
               for a, b in zip(*dets) for key in dryrun.DET_KEYS
               if len(a[key])), default=0.0)
    check(err <= DDP_DETS_TOL, f"ddp evaluate: detections off by {err}")
    check(sharded["results"] == single["results"],
          f"ddp evaluate: the AP differs from one process's (detections "
          f"within {err}): {sharded['results']} vs {single['results']}")
    mid = range(2, DDP_TRAIN_STEPS)
    official = sharded["results"]["official"].splitlines()
    log(f"ddp (b) train() over {DDP_RANKS} gloo ranks on cuda:0 ({card}): "
        f"{DDP_TRAIN_STEPS} + {DDP_RESUME_STEPS} resumed steps at global "
        f"batch {TRAIN_BATCH} with the sampler on {FHD_FRAMES} fixture "
        f"frames, losses {[round(losses[i], 6) for i in sorted(losses)]}, "
        f"step ms median of steps 2-{DDP_TRAIN_STEPS - 1} "
        f"{statistics.median(step_ms[i] for i in mid):.3f} (all "
        f"{[round(step_ms[i], 3) for i in sorted(step_ms)]}; two processes "
        f"sharing one card, not a two-card number), data-fetch ms "
        f"{[round(fetch_ms[i], 3) for i in sorted(fetch_ms)]}; one log, "
        f"checkpoints {info['all_ckpts']['voxelnet']}; evaluate() over the "
        f"ranks equals one process's (AP text identical, detections "
        f"within {err:.3e}; {evals[-1]}; one process {single_wall:.3f} s); "
        f"ranks' wall {wall:.3f} s: " + " | ".join(official))


def _nccl_rank(rank, world_size, init_method, paths, out, config,
               model_dir):
    """Rank body of phase 16 (c), one NCCL rank: the step on phase 7's
    batch under ``cudnn.deterministic`` (for the bitwise comparison),
    the host syncs of a step, then ``train()`` through the entry point."""
    torch.backends.cudnn.deterministic = True
    res = dryrun.step_rank(rank, world_size, init_method, "cuda", "nccl",
                           *paths, out)
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = load_pipeline_config(paths[0])
    parts = build_network(cfg, device)
    parts["net"].load_state_dict(torch.load(paths[2], weights_only=True))
    with open(paths[1], "rb") as f:
        ex = mesh.put_sharded(pickle.load(f), device)
    opt, lr_fn, mom_fn = opt_builder.build(
        cfg.train_config.optimizer, cfg.train_config.steps,
        list(parts["net"].parameters()))
    res["syncs"] = sync_count(make_train_step(
        parts["net"], parts["spec"], opt, lr_fn, mom_fn), ex)
    del parts, ex
    torch.backends.cudnn.deterministic = False
    train(config, model_dir, display_step=1, measure_time=True,
          device="cuda", dist_backend="nccl")
    res["launches"] = launch_counts()
    return res


def ddp_nccl(device, work, root, inputs, single, launches, card):
    """Phase 16 (c): one NCCL rank; its step bitwise the ungrouped step
    on the same batch (both under ``cudnn.deterministic``), 0 host syncs,
    and ``train()`` for DDP_NCCL_STEPS steps."""
    cfg, host, weights, paths = inputs
    config = fixture_config(CONFIG, root, work / "nccl.config",
                            DDP_NCCL_STEPS)
    model_dir = work / "model_nccl"
    torch.cuda.empty_cache()
    (res,) = mesh.run_ranks(_nccl_rank, 1, args=(
        paths, str(work / "nccl"), config, str(model_dir)),
        timeout=DDP_TIMEOUT)
    _add(launches, res["launches"])
    grouped = torch.load(res["path"], weights_only=False)
    torch.backends.cudnn.deterministic = True
    try:
        ref = _ungrouped_step(cfg, weights, host, device)
    finally:
        torch.backends.cudnn.deterministic = False
    differ = [n for n, v in ref["grads"].items()
              if not torch.equal(v, grouped["grads"][n])]
    differ += [n for n, v in ref["state"].items()
               if not torch.equal(v, grouped["state"][n])]
    losses, step_ms, _, evals, _ = _log_steps(model_dir)
    n_sync, first = res["syncs"]
    log(f"ddp (c) one NCCL rank ({card}): the step at batch {TRAIN_BATCH} "
        f"bitwise the ungrouped step ({len(differ)} tensors differ), "
        f"{n_sync} host syncs{first}; step ms (cudnn.deterministic) "
        f"grouped {res['ms']:.3f} vs ungrouped {ref['ms']:.3f} (without "
        f"cudnn.deterministic, one process: {single['ms']:.3f}); train() "
        f"{DDP_NCCL_STEPS} steps under NCCL, losses "
        f"{[round(losses[i], 6) for i in sorted(losses)]}, step ms "
        f"{[round(step_ms[i], 3) for i in sorted(step_ms)]} (median "
        f"{statistics.median(step_ms.values()):.3f}), {evals[-1]}")
    check(not differ, f"ddp nccl: the grouped step differs on {differ}")
    check(n_sync == 0, f"ddp nccl: {n_sync} host syncs{first}")
    check(sorted(losses) == list(range(1, DDP_NCCL_STEPS + 1)),
          f"ddp nccl train: logged steps {sorted(losses)}")


def phase_ddp(device, work, root):
    """Phase 16: data-parallel training at car.fhd's width on phase 10's
    tree at ``root``: (a) the sharded step's parity, (b) train() and
    evaluate() over two gloo ranks, (c) one NCCL rank, (d) the dry run at
    the published PointPillars width. Returns the kernel launches of the
    ranks, summed."""
    work.mkdir()
    card = card_name()
    t0 = time.perf_counter()
    launches = dict.fromkeys((name for name, _, _, _ in KERNELS), 0)
    inputs = ddp_inputs(device, work)
    single = ddp_step_parity(device, work, inputs, launches, card)
    ddp_entry_points(device, work, root, launches, card)
    ddp_nccl(device, work, root, inputs, single, launches, card)
    t1 = time.perf_counter()
    res = dryrun.dryrun_multichip(DDP_RANKS, full=True, device=str(device),
                                  timeout=DDP_TIMEOUT)
    _add(launches, res["launches"])
    log(f"ddp (d) dryrun_multichip({DDP_RANKS}, full=True) on cuda:0: loss "
        f"{res['loss']:.6f}, {res['num_det']} scored detections, max error "
        f"{res['max_err']}, {time.perf_counter() - t1:.3f} s")
    for name in PATH_KERNELS["ddp"]:
        check(launches[name] > 0, f"the ddp path never launched {name}")
    log(f"ddp: launches in the ranks {launches}; phase wall "
        f"{time.perf_counter() - t0:.3f} s ({card})")
    return launches


def phase_proofs(work):
    """The three learning proofs (``tools/overfit_ap.py``, 1000 steps
    each), last and together: three processes at once on the card
    (``overfit_ap.run_at_once``), each reporting its APs and kernel
    launches. Returns the launches by proof."""
    card = card_name()
    t0 = time.perf_counter()
    done = overfit_ap.run_at_once(
        [(model, steps) for _, model, steps in PROOFS], work, PROOF_TIMEOUT)
    total = time.perf_counter() - t0
    results, walls, launches = {}, {}, {}
    for name, model, _ in PROOFS:
        results[name], walls[name] = done[model]
        launches[name] = by_name(results[name].pop("launches"))
        for kernel in PROOF_KERNELS[name]:
            check(launches[name][kernel] > 0,
                  f"the {name} never launched {kernel}")
    pp, fhd, all_ = (results[name] for name, _, _ in PROOFS)
    jax_ref = json.loads(Path("OVERFIT_AP.json").read_text())
    for name, label, res in (("pp_proof", "PointPillars", pp),
                             ("fhd_proof", "car.fhd", fhd)):
        log(f"{label} learning proof (second_tpu_torch.tools.overfit_ap "
            f"--model {res['model']}, {res['steps']} steps, "
            f"{res['num_gt']} GT): bbox {res['bbox']}, bev {res['bev']}, "
            f"3d {res['3d']}, aos {res['aos']}; wall {walls[name]:.3f} s; "
            f"the tool's targets " + ", ".join(
                f"{k} >= {v} {'met' if res[k] >= v else 'missed'}"
                for k, v in PROOF_TARGETS.items()))
        check(res["bev"] >= PROOF_FLOOR and res["3d"] >= PROOF_FLOOR,
              f"{label} learning proof: bev {res['bev']}, 3d {res['3d']} "
              f"below {PROOF_FLOOR}")
    log(f"the JAX package's OVERFIT_AP.json (TPU, {jax_ref['steps']} "
        f"steps, PointPillars): bbox {jax_ref['bbox']}, bev "
        f"{jax_ref['bev']}, 3d {jax_ref['3d']}, aos {jax_ref['aos']}")
    log(f"all.fhd learning proof (--model all, {all_['steps']} steps, "
        f"{all_['frames']} frames, GT {all_['num_gt']}; IoU 0.7 Car and "
        f"Van, 0.5 Cyclist and Pedestrian): " + "; ".join(
            f"{c} bbox {ap['bbox']}, bev {ap['bev']}, 3d {ap['3d']}, aos "
            f"{ap['aos']}" for c, ap in all_["classes"].items())
        + f"; wall {walls['all_proof']:.3f} s; floor "
        f"{overfit_ap.ALL_FLOOR} on bev and 3d")
    check(overfit_ap.passed(all_),
          f"all.fhd learning proof below {overfit_ap.ALL_FLOOR}: "
          f"{all_['classes']}")
    log(f"the proofs together ({card}): {total:.3f} s wall, each "
        f"{ {k: round(v, 3) for k, v in walls.items()} }, sum "
        f"{sum(walls.values()):.3f} s; launches {launches}")
    return launches


def main():
    t_start = time.perf_counter()
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
    batch = prepare_train_batch(build_prep_func(
        without_sampler(cfg).train_input_reader, parts, training=True))
    results["sparse_conv_weight_grad"], k1_err = phase_backward_kernels(
        parts["net"], batch, device)
    k1 = results["sparse_conv_gather_gemm"]
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_err)
    launches["train"] = phase_train(cfg, parts, batch, device)
    del parts, batch
    launches["pp_inference"], results["greedy_nms"]["pp_candidates"] = (
        phase_pp(device))
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        launches["pp_train"], pp_root = phase_pp_train(device, work / "pp")
        launches["fhd_train"], root = phase_fhd_train(device, work)
        launches["fhd_device"] = phase_fhd_device(ctx, device, root, work)
        launches["all_fhd"] = phase_all_fhd(device, work / "all_fhd")
        launches["bf16"], results["sparse_conv_gather_gemm_bf16"] = (
            phase_bf16(ctx, device, work, pp_root, root))
        launches["nusc_mhead"] = phase_nusc_mhead(device, work / "nusc_mhead")
        launches["nusc_res8x"], results["sparse_conv_gather_gemm"]["wide"] = (
            phase_nusc_res8x(device))
        launches["finetune"] = phase_finetune(device, work / "finetune", root)
        launches["ddp"] = phase_ddp(device, work / "ddp", root)
        proofs = phase_proofs(work / "proofs")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for name, _, source, replaces in KERNELS:
        by_path = {path: counts[name] for path, counts in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "proof_launches": {path: counts[name] for path, counts
                                           in proofs.items()},
                        **results[name]})
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
