"""K1-bf16's per-conv device-only ms in two checkouts, taken in turns on
one card.

    python -m second_tpu_torch.tools.k1_bf16_ab BEFORE_DIR [AFTER_DIR]

Runs ``chip_smoke.k1_bf16_kernel`` (phase 13's check of K1-bf16 against
its plain version on the 10 sparse convs of a car.fhd frame, with its
timings) from each checkout in a process of its own, in the order
before, after, after, before (``AFTER_DIR`` defaults to the current
directory). Each process builds its checkout's kernel into that
checkout's ``csrc/build``. Prints every run's log, then a table of the
device-only ms (20 calls in a CUDA graph) of each conv: both runs of
each side, each side's spread (the larger minus the smaller), and the
frame totals. Needs a CUDA card; prints its name and power limit first.
"""

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

RUN_PHASE = """
import sys
import torch
import chip_smoke as cs
from second_tpu_torch.core.inference import InferenceContext
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
device = torch.device("cuda", 0)
ctx = InferenceContext()
ctx.build(cs.CONFIG, device=device)
ctx.init_random(0)
cs.k1_bf16_kernel(ctx, device)
"""
LINE = re.compile(r"K1-bf16 (\w+): .* kernel ([\d.]+) ms \(device ([\d.]+)\)")


def run_tree(tree):
    """{conv: device ms} of one ``k1_bf16_kernel`` run in ``tree``."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN_PHASE], cwd=tree,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    print(f"--- {tree} (exit {proc.returncode})\n{proc.stdout}"
          f"{proc.stderr[-4000:]}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"k1_bf16_kernel failed in {tree}")
    return {m.group(1): float(m.group(3))
            for m in map(LINE.search, proc.stdout.splitlines()) if m}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("before", type=Path)
    parser.add_argument("after", type=Path, nargs="?", default=Path("."))
    args = parser.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    order = [("before", args.before), ("after", args.after),
             ("after", args.after), ("before", args.before)]
    runs = {"before": [], "after": []}
    for side, tree in order:
        runs[side].append(run_tree(tree.resolve()))
    convs = list(runs["before"][0])
    print("conv | before (2 runs) | spread | after (2 runs) | spread | "
          "after / before")
    for conv in convs + ["frame"]:
        vals = {side: [sum(r.values()) if conv == "frame" else r[conv]
                       for r in rs] for side, rs in runs.items()}
        b, a = vals["before"], vals["after"]
        print(f"{conv} | {b[0]:.4f} {b[1]:.4f} | {max(b) - min(b):.4f} | "
              f"{a[0]:.4f} {a[1]:.4f} | {max(a) - min(a):.4f} | "
              f"{sum(a) / sum(b):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
