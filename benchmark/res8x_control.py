"""Readings for the limits of a nuScenes residual sparse cell (``kind``
``nusc_voxel_sweep``): the port's requests and the control's, judged by
the reference with its label check, seed by seed.

    python3 -m benchmark.res8x_control --workload nusc_res8x.sweep \
        --seeds 11,12,13 --side both [--requests 16]

``program``: the seed's first requests through the timed path's calls,
untimed, judged as a run judges them, with the stage counts' overflow.
``control``: the reference put in the port's place, computed one
precision below the configuration's (TF32 products for float32 with
TF32 off): its host arrays, its preds and its greedy NMS detections
with their labels, judged against the float32 reference. One JSON line
per seed and side. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time

import torch

from benchmark import common
from benchmark.control import tf32
from benchmark.kinds import nusc_voxel_sweep as kind
from benchmark.kinds.nusc_sweep import info
from benchmark.kinds.sweep import Capture
from benchmark.reference import judge, multihead, res8x


def readings(config, mix, seed, side, requests, device):
    """{number: reading} of ``side`` on ``requests`` frames of the seed's
    pool."""
    model, tol = config["model"], mix["tolerance"]
    ctx, w, pool = kind.build(config, mix, seed, device)
    cap = Capture(ctx, requests, seed)
    counts = kind.StageCounts(ctx)
    nums = {"prep_mismatch": 0, "preds_err": 0.0, "det_err": 0.0,
            "nms_violations": 0}
    for i in range(min(requests, len(pool))):
        pts = pool[i]
        if side == "program":
            cap.current = {}
            ex = ctx.get_inference_input_dict(info(i), pts)
            out = ctx.inference(ex)[0]
            got = {"ex": ex, "preds": cap.current["preds"],
                   "boxes": out["box3d_lidar"], "scores": out["scores"],
                   "labels": out["label_preds"]}
            cap.current = None
        else:
            tf32(True)
            r = res8x.request(model, w, pts, device, mix["candidate_margin"])
            b, s, lab = multihead.detections(model, r["cand"])
            got = {"ex": r["ex"], "preds": r["preds"], "boxes": b,
                   "scores": s, "labels": lab}
            tf32(config["precision"]["tf32"])
        ref = res8x.request(model, w, pts, device, mix["candidate_margin"])
        err = judge.preds_err(got["preds"], ref["preds"])
        nums["prep_mismatch"] += judge.prep_mismatch(got["ex"], ref["ex"])
        nums["preds_err"] = max(nums["preds_err"], err)
        d, bad, why = multihead.judge(model, got["boxes"], got["scores"],
                                      got["labels"], ref["cand"], tol)
        nums["det_err"] = max(nums["det_err"], d)
        nums["nms_violations"] += bad
        print(f"{side} seed {seed} request {i}: preds {err:.3e} det "
              f"{d:.3e} violations {bad} {why} dets {len(got['scores'])}",
              file=sys.stderr, flush=True)
    if side == "program":
        nums["sparse_rows_overflow"] = counts.overflow()
    return nums


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--side", choices=("program", "control", "both"),
                   default="both")
    p.add_argument("--requests", type=int, default=None)
    args = p.parse_args(argv)
    common.set_cache_env()
    bench = common.load_benchmark()
    cell = common.find_cell(bench, args.workload)
    config = common.load_config(cell["config"])
    mix = common.load_mix(cell["traffic"])
    if mix["kind"] != "nusc_voxel_sweep":
        common.fail(f"{args.workload} is not a nusc_voxel_sweep cell")
    if not torch.cuda.is_available():
        common.fail("the readings are taken on the card")
    device = torch.device("cuda", 0)
    sides = ("program", "control") if args.side == "both" else (args.side,)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in sides:
            t = time.perf_counter()
            nums = readings(config, mix, seed, side,
                            args.requests or mix["sample"], device)
            print(json.dumps({"cell": cell["name"], "seed": seed,
                              "side": side, "readings": nums,
                              "seconds": time.perf_counter() - t}),
                  flush=True)


if __name__ == "__main__":
    main()
