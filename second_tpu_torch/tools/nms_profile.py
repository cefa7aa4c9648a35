"""Where K3 (``csrc/rotated_iou.cu``) and K4 (``csrc/greedy_nms.cu``)
spend their time on the card: the device time of each kernel they
launch, from ``torch.profiler`` over 20 calls, on two inputs:

* ``chip_smoke.py`` phase 2's boxes: 100 clusters of 10 car-sized boxes
  (sigma 1 m) over the 70 x 80 m scene, clusters in consecutive ranks;
* frame 0's NMS candidates: ``make_kitti_scene(RandomState(0))`` through
  car.fhd at full width with random weights from seed 0, top 1000 by
  score (near-tied scores keep anchor order, so ranks are near in
  space).

For each it prints the share of pairs that survive K3's far-pair reject
and K4's kept count. Needs a CUDA card; prints the card's name and
power limit first.

    python -m second_tpu_torch.tools.nms_profile
"""

import re
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..core.inference import InferenceContext
from ..data import make_kitti_scene
from ..ops import cuda_iou, cuda_nms

CONFIG = "configs/car.fhd.config"
CALLS = 20


def clustered_boxes(device):
    """``chip_smoke.py`` phase 2's boxes and validity (seed 1)."""
    rng = np.random.RandomState(1)
    centers = np.stack([rng.uniform(0, 70.4, 100), rng.uniform(-40, 40, 100)],
                       1).repeat(10, 0) + rng.normal(0, 1.0, (1000, 2))
    boxes = np.concatenate([
        centers, rng.normal([1.6, 3.9], 0.1, (1000, 2)),
        rng.uniform(-np.pi, np.pi, (1000, 1))], 1).astype(np.float32)
    valid = rng.uniform(size=1000) < 0.9
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device), 0.01)


def frame0_candidates(device):
    """Frame 0's NMS candidates (x, y, w, l, r), their validity and the
    IoU threshold, as ``ops.nms.nms_bev`` builds them."""
    ctx = InferenceContext()
    ctx.build(CONFIG, device=device)
    ctx.init_random(0)
    example = ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(0))[0])
    preds, _ = ctx.run(example)
    spec = ctx.parts["spec"]
    anchors = torch.from_numpy(example["anchors"][0].astype(np.float32))
    box = spec.decode(preds["box_preds"][0], anchors.to(device))
    scores = torch.sigmoid(preds["cls_preds"][0]).max(-1).values
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    k = spec.nms_pre_max_sizes[0]
    cand = box[top_i[:k]][:, [0, 1, 3, 4, 6]].contiguous()
    return (cand, top_s[:k] >= spec.nms_score_thresholds[0],
            spec.nms_iou_thresholds[0])


def kernel_us(boxes, valid, threshold):
    """Mean device µs per call of each kernel K3 and K4 launch."""
    iou = cuda_iou.rotated_iou_matrix(boxes, boxes)
    cuda_nms.greedy_suppress(iou, valid, threshold)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            cuda_iou.rotated_iou_matrix(boxes, boxes)
            cuda_nms.greedy_suppress(iou, valid, threshold)
        torch.cuda.synchronize()
    return {re.search(r"\w+_kernel", evt.key).group(0):
            evt.self_device_time_total / CALLS
            for evt in prof.key_averages()
            if evt.self_device_time_total > 0
            and re.search(r"\w+_kernel", evt.key)}


def main():
    if not torch.cuda.is_available():
        print("nms_profile: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for name, make in (("phase 2 boxes", clustered_boxes),
                       ("frame 0 candidates", frame0_candidates)):
        boxes, valid, threshold = make(device)
        far = cuda_iou.far_pairs(boxes, boxes)
        iou = cuda_iou.rotated_iou_matrix(boxes, boxes)
        keep = cuda_nms.greedy_suppress(iou, valid, threshold)
        print(f"{name}: n = {len(boxes)}, pairs surviving the reject "
              f"{1 - far.float().mean().item():.4f}, valid "
              f"{int(valid.sum())}, kept {int(keep.sum())} (threshold "
              f"{threshold})")
        for kernel, us in sorted(kernel_us(boxes, valid, threshold).items()):
            print(f"  {kernel}: {us:.3f} us per call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
