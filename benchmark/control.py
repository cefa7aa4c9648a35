"""Readings for the limits of a cell: the port's requests and the
control's, judged by the reference, seed by seed.

    python3 -m benchmark.control --workload car_fhd.sweep \
        --seeds 11,12,13 --side both [--requests 16]

``program``: the seed's sample of requests through the timed path's
calls (``get_inference_input_dict`` then ``inference``), untimed, judged
as a run judges them. ``control``: the reference put in the port's
place, computed one precision below the configuration's (TF32 products
for float32 with TF32 off): its host arrays, its preds and its greedy
NMS detections, judged against the float32 reference. One JSON line per
seed and side. The benchmark's own runs never run the control.

A training cell reads, on each seed, the port's first steps, the control
and the half-batch fault in one process (``--side`` does not apply).
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchmark import common
from benchmark.kinds import sweep
from benchmark.reference import boxes, judge, pipeline


def tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def train_readings(config, mix, seed, device, tmp):
    """{side: readings} of a training cell on one seed: the port's first
    steps, the reference in TF32 in its place, and the half-batch fault
    (the reference's step on the first half of each batch, its mean over
    those frames), each against the float32 reference on the port's
    batches."""
    from benchmark.kinds import train
    from benchmark.reference import train as ref_train

    state = train.build(config, mix, seed, device, tmp)
    first = train.first_steps(state, mix["reference_steps"])
    w0, names = state["w0"], state["names"]
    del state
    ref = train.reference(config, w0, names, first["batches"], device)
    b1 = ref_train.one_cycle(config["optimizer"], 0)[1]

    def as_first(steps):
        losses, g1, w = steps
        return {"losses": losses, "params": w,
                "mu1": {n: g1[n] * (1 - b1) for n in names}}

    out = {"program": train.judge(config["model"], config["optimizer"],
                                  first, w0, names, ref)}
    tf32(True)
    steps = train.reference(config, w0, names, first["batches"], device)
    tf32(config["precision"]["tf32"])
    out["control"] = train.judge(config["model"], config["optimizer"],
                                 as_first(steps), w0, names, ref)
    half = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
            for b in first["batches"]]
    steps = train.reference(config, w0, names, half, device)
    out["half_batch"] = train.judge(config["model"], config["optimizer"],
                                    as_first(steps), w0, names, ref)
    return out


def readings(config, mix, seed, side, requests, device):
    """{number: reading} of ``side`` on ``requests`` sweeps of the seed's
    pool."""
    model, tol = config["model"], mix["tolerance"]
    ctx, w, pool = sweep.build(config, mix, seed, device)
    cap = sweep.Capture(ctx, requests, seed)
    nums = {"prep_mismatch": 0, "preds_err": 0.0, "det_err": 0.0,
            "nms_violations": 0}
    for i in range(min(requests, len(pool))):
        pts = pool[i]
        if side == "program":
            cap.current = {}
            ex = ctx.get_inference_input_dict({}, pts)
            out = ctx.inference(ex)[0]
            got = {"ex": ex, "preds": cap.current["preds"],
                   "boxes": out["box3d_lidar"], "scores": out["scores"]}
            cap.current = None
        else:
            tf32(True)
            r = pipeline.request(model, w, pts, device,
                                 mix["candidate_margin"])
            b, s = boxes.detections(model, r["cand"])
            got = {"ex": r["ex"], "preds": r["preds"], "boxes": b,
                   "scores": s}
            tf32(config["precision"]["tf32"])
        ref = pipeline.request(model, w, pts, device, mix["candidate_margin"])
        nums["prep_mismatch"] += judge.prep_mismatch(got["ex"], ref["ex"])
        nums["preds_err"] = max(nums["preds_err"],
                                judge.preds_err(got["preds"], ref["preds"]))
        d, bad, why = judge.judge(model, got["boxes"], got["scores"],
                                  ref["cand"], tol)
        nums["det_err"] = max(nums["det_err"], d)
        nums["nms_violations"] += bad
        print(f"{side} seed {seed} request {i}: preds "
              f"{judge.preds_err(got['preds'], ref['preds']):.3e} det {d:.3e} "
              f"violations {bad} {why} dets {len(got['scores'])}",
              file=sys.stderr, flush=True)
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
    if not torch.cuda.is_available():
        common.fail("the readings are taken on the card")
    device = torch.device("cuda", 0)
    sides = ("program", "control") if args.side == "both" else (args.side,)
    if mix["kind"] == "train":
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
                out = train_readings(config, mix, seed, device, Path(tmp))
            for side, nums in out.items():
                print(json.dumps({"cell": cell["name"], "seed": seed,
                                  "side": side, "readings": nums,
                                  "seconds": time.perf_counter() - t}),
                      flush=True)
        return
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
