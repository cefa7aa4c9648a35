"""The spread of all.fhd's learning proof: its APs over several runs,
alone and with the PointPillars and car.fhd proofs running beside it
(three processes on one card, as ``chip_smoke.py`` ran them).

    python -m second_tpu_torch.tools.proof_spread [--rounds 4]
        [--json out.json]

Each round runs the all.fhd proof (``tools/overfit_ap.py --model all``,
1000 steps) once alone, then once together with the other two proofs;
every proof is its own ``overfit_ap`` process with TF32 off
(``overfit_ap.run_at_once``). The proof's shuffle is unseeded, so the
runs differ as the proof's own runs do. Prints one line per run (each class's bev and 3d AP, the verdict at
``overfit_ap.ALL_FLOOR``, the wall time) and a summary of all.fhd's
readings by setting; writes every reading to ``--json``. Card only:
about 6 minutes a round on an H100.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import (
    cuda_iou,
    cuda_nms,
    cuda_sparse_conv,
    cuda_sparse_conv_dw,
)
from . import overfit_ap

STEPS = 1000
TIMEOUT = 900.0


def summary(res):
    """bev/3d of each class of an all.fhd result, or of a car proof."""
    if "classes" in res:
        return {c: (ap["bev"], ap["3d"]) for c, ap in res["classes"].items()}
    return {"Car": (res["bev"], res["3d"])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("proof_spread: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    modules = (cuda_sparse_conv, cuda_sparse_conv_dw, cuda_iou, cuda_nms)
    with ThreadPoolExecutor(len(modules)) as pool:  # one nvcc per source
        list(pool.map(lambda m: m._load(), modules))
    work = Path(tempfile.mkdtemp(prefix="proof_spread_"))
    readings = []
    settings = (("alone", ("all",)), ("together", ("pp", "fhd", "all")))
    for r in range(args.rounds):
        for setting, models in settings:
            t0 = time.perf_counter()
            res = overfit_ap.run_at_once(
                [(m, STEPS) for m in models], work / f"{r}_{setting}",
                TIMEOUT)
            wall = time.perf_counter() - t0
            entry = {"round": r, "setting": setting, "wall_s": wall,
                     "runs": {m: {"aps": summary(v),
                                  "passed": overfit_ap.passed(v),
                                  "wall_s": w}
                              for m, (v, w) in res.items()}}
            readings.append(entry)
            print(json.dumps(entry), flush=True)
    print(f"all.fhd over {args.rounds} rounds ({smi}), floor "
          f"{overfit_ap.ALL_FLOOR} on bev and 3d:")
    for setting, _ in settings:
        runs = [e["runs"]["all"] for e in readings
                if e["setting"] == setting]
        classes = sorted(runs[0]["aps"])
        for c in classes:
            bev = [run["aps"][c][0] for run in runs]
            d3 = [run["aps"][c][1] for run in runs]
            print(f"  {setting:8s} {c:10s} bev {bev} 3d {d3} "
                  f"(min {min(d3)}, max {max(d3)})")
        print(f"  {setting:8s} passed {sum(r['passed'] for r in runs)} of "
              f"{len(runs)}; wall {[round(r['wall_s'], 3) for r in runs]}")
    if args.json:
        Path(args.json).write_text(json.dumps(readings, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
