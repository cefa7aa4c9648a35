"""Detection-quality proof of the port: overfit a detector on a mini KITTI
tree and report the official KITTI AP on the training frames (twin of
the JAX package's ``tools/overfit_ap.py``, which proves PointPillars).

    python -m second_tpu_torch.tools.overfit_ap --steps 1000
    python -m second_tpu_torch.tools.overfit_ap --model fhd --steps 1000
    python -m second_tpu_torch.tools.overfit_ap --model all --steps 1000
    python -m second_tpu_torch.tools.overfit_ap --steps 250 --device cpu

It runs the whole chain through the port's entry points: prep ->
``train`` -> checkpoints -> the eval (K3 and K4 in car.fhd's rotated
NMS, K4 in PointPillars' on the card) -> lidar->camera conversion ->
the official 41-point AP, and passes only when all of them cooperate.
``--model pp`` (the default) ships points with compact targets and
voxelizes on the device, with the flat-pillar eval; ``--model fhd``
ships host voxels and rulebooks through SpMiddleFHD (K1 and K2);
``--model all`` is the four-class all.fhd on car.fhd's network.

The fixture and config edits are the JAX tool's, for the same reasons:
8 frames x 8 cars = 64 GT (the 41-point curve needs >= 41 GT), cars
kept apart (``make_scene`` min_gap 4.6 m), inside the camera frustum;
``direction_limit_offset`` 0 (1 reproduces the reference's yaw flip and
zeroes AOS), batch 2, no sampler, no augmentation. The range is
clipped: ``configs/pointpillars/car/xyres_16.config`` to [0, -10.24,
20.48, 10.24] (a 128 x 128 grid, 6000 voxels), ``configs/car.fhd.config``
to [0, -12.8, 25.6, 12.8] (a [41, 512, 512] grid that 8 divides, 12000
voxels).

``--model all`` (no JAX target: the JAX tool proves PointPillars only)
clips ``configs/all.fhd.config`` as car.fhd and trains on 24 frames of
two objects of each class (Car, Cyclist, Pedestrian, Van;
``data.synthetic.CLASS_SIZES``), so each class has 48 GT: the 41-point
curve needs >= 41 of a class to reach 100 (with n GT at most n of its
41 recall points are reached). It reports each class's official AP,
the first block of each: IoU 0.7 for Car and Van, 0.5 for Pedestrian
and Cyclist.

Prints the four APs of the strict-overlap block (for ``all``, of each
class under "classes") and the process's kernel launches
(``launches``) as one JSON line (and writes it to ``--json`` when
given); exits 1 unless 3d >= 85 and aos >= 80, the JAX tool's
targets, or for ``all`` unless every class's bev and 3d AP reach
``ALL_FLOOR``.
"""

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from ..configs import load_pipeline_config, schema
from ..data.kitti_dataset import create_kitti_info_file
from ..ops import launch_counts
from ..train.__main__ import train
from ..utils.config_tool import change_detection_range
from .kitti_fixture import build_kitti_dir

CONFIGS = Path(__file__).resolve().parents[2] / "configs"
CONFIG = CONFIGS / "pointpillars" / "car" / "xyres_16.config"
# per model: the config, its clipped BEV range, its voxel capacity, and
# the fixture's x range (the cars' centres keep 5 m off its ends)
MODELS = {
    "pp": (CONFIG, [0.0, -10.24, 20.48, 10.24], 6000, (2.0, 20.48)),
    "fhd": (CONFIGS / "car.fhd.config", [0.0, -12.8, 25.6, 12.8], 12000,
            (2.0, 25.6)),
    "all": (CONFIGS / "all.fhd.config", [0.0, -12.8, 25.6, 12.8], 12000,
            (2.0, 25.6)),
}
# per model: the frames and the objects of each frame (8 cars; all.fhd:
# 2 of each class)
SCENES = {
    "pp": (8, dict(num_cars=8)),
    "fhd": (8, dict(num_cars=8)),
    "all": (24, dict(classes={"Car": 2, "Cyclist": 2, "Pedestrian": 2,
                              "Van": 2})),
}
# a proof's process (run_at_once): this module's command line with TF32
# off, as chip_smoke.py runs the card
PROCESS_MAIN = ("import sys, torch; "
                "torch.backends.cuda.matmul.allow_tf32 = False; "
                "torch.backends.cudnn.allow_tf32 = False; "
                "from second_tpu_torch.tools import overfit_ap; "
                "sys.exit(overfit_ap.main())")
# the floor of every class's bev and 3d AP in the all.fhd proof: the
# PointPillars and car.fhd proofs' floor; a class that learned ranks
# most of its 48 objects (each class read 71.97-90.91 on the H100)
ALL_FLOOR = 55.0


def overfit_config(root, steps, model="pp"):
    """``model``'s config with the proof's edits, reading the tree at
    ``root``."""
    path, bev_range, max_voxels, _ = MODELS[model]
    cfg = load_pipeline_config(str(path))
    change_detection_range(cfg.model.second, bev_range)
    cfg.model.second.direction_limit_offset = 0.0
    for reader, tr in ((cfg.train_input_reader, True),
                       (cfg.eval_input_reader, False)):
        reader.dataset.kitti_root_path = str(root)
        reader.dataset.kitti_info_path = str(
            root / ("kitti_infos_train.pkl" if tr
                    else "kitti_infos_val.pkl"))
        reader.batch_size = 2
        reader.preprocess.max_number_of_voxels = max_voxels
        reader.preprocess.num_workers = 0
        reader.preprocess.database_sampler = schema.Sampler.from_raw({})
    p = cfg.train_input_reader.preprocess
    p.groundtruth_localization_noise_std = [0.0, 0.0, 0.0]
    p.groundtruth_rotation_uniform_noise = [0.0, 0.0]
    p.global_rotation_uniform_noise = [0.0, 0.0]
    p.global_scaling_uniform_noise = [1.0, 1.0]
    p.global_random_rotation_range_per_object = [0.0, 0.0]
    p.global_translate_noise_std = [0.0, 0.0, 0.0]
    p.random_flip_x = False
    p.random_flip_y = False
    cfg.train_config.steps = steps
    cfg.train_config.steps_per_eval = steps * 2
    return cfg


def read_ap(log_text, class_name=None):
    """bbox, bev, 3d and aos AP of the last official evaluation's
    strict-overlap (0.70) block in a log.txt, or of ``class_name``'s
    first block (its strict overlaps)."""
    tail = log_text[log_text.rfind("Evaluation official"):]
    if class_name is None:
        block = tail[:tail.find("@0.70, 0.50")]
    else:
        block = tail[tail.find(f"{class_name} AP(Average Precision)@"):]
        end = block.find("AP(Average Precision)", len(class_name) + 2)
        block = block if end < 0 else block[:end]
    res = {}
    for key, pat in (("bbox", r"bbox AP:([0-9.]+)"),
                     ("bev", r"bev  AP:([0-9.]+)"),
                     ("3d", r"3d   AP:([0-9.]+)"),
                     ("aos", r"aos  AP:([0-9.]+)")):
        m = re.search(pat, block)
        res[key] = float(m.group(1)) if m else float("nan")
    return res


def run(steps=1000, frames=None, out=None, seed=3, device="cuda",
        model="pp"):
    """Build the tree, train, evaluate; returns the APs with the run's
    settings (``frames`` None: the model's, ``SCENES``)."""
    tmp = Path(out or tempfile.mkdtemp(prefix="overfit_ap_"))
    root = tmp / "kitti"
    default_frames, scene = SCENES[model]
    frames = frames or default_frames
    # y in [-5.24, 5.24] and x from 7 (the fixture keeps 5 m off the
    # range's ends): inside both the clipped detection range and the
    # camera frustum; min_gap 4.6 m keeps the 8 objects pairwise
    # disjoint (car diagonal ~4.2 m)
    ids = build_kitti_dir(
        root, num_frames=frames, seed=seed,
        scene_kwargs=dict(scene, x_range=MODELS[model][3],
                          y_range=(-10.24, 10.24), min_gap=4.6))
    create_kitti_info_file(str(root), train_img_ids=ids, val_img_ids=ids)
    mod = tmp / f"{model}_overfit.config"
    mod.write_text(overfit_config(root, steps, model).to_text())
    train(str(mod), str(tmp / "model"), device=device)
    log_text = (tmp / "model" / "log.txt").read_text()
    if model == "all":
        res = {"classes": {name: read_ap(log_text, name)
                           for name in sorted(scene["classes"])}}
        num_gt = {name: frames * n for name, n in scene["classes"].items()}
    else:
        res = read_ap(log_text)
        num_gt = frames * scene["num_cars"]
    res.update(model=model, steps=steps, frames=frames, num_gt=num_gt,
               seed=seed)
    return res


def passed(res):
    """The proof's verdict: the JAX tool's targets, or for all.fhd every
    class's bev and 3d AP at ``ALL_FLOOR`` or above."""
    if res["model"] == "all":
        return all(ap[k] >= ALL_FLOOR for ap in res["classes"].values()
                   for k in ("bev", "3d"))
    return res["3d"] >= 85.0 and res["aos"] >= 80.0


def run_at_once(proofs, work, timeout=600.0):
    """Run ``proofs``, (model, steps) pairs, at once, each in its own
    process (:data:`PROCESS_MAIN`) writing under ``work``; returns
    {model: (its JSON result, with the process's "launches"; its wall
    s)}. Raises when a process fails or the proofs outlast ``timeout``
    s; a missed target (exit 1) is a result."""
    work = Path(work)
    work.mkdir(parents=True)
    start = time.perf_counter()
    procs = {}
    for model, steps in proofs:
        log = open(work / f"{model}.log", "w")
        procs[model] = (subprocess.Popen(
            [sys.executable, "-c", PROCESS_MAIN, "--model", model,
             "--steps", str(steps), "--out", str(work / model), "--json",
             str(work / f"{model}.json")],
            stdout=log, stderr=subprocess.STDOUT), log)
    walls = {}
    try:
        while len(walls) < len(procs):
            for model, (proc, _) in procs.items():
                if model not in walls and proc.poll() is not None:
                    walls[model] = time.perf_counter() - start
            if time.perf_counter() - start > timeout:
                raise RuntimeError(f"the proofs outlasted {timeout} s")
            time.sleep(0.5)
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
    out = {}
    for model, (proc, _) in procs.items():
        path = work / f"{model}.json"
        if proc.returncode not in (0, 1) or not path.is_file():
            tail = (work / f"{model}.log").read_text()[-3000:]
            raise RuntimeError(f"the {model} proof failed (exit "
                               f"{proc.returncode}):\n{tail}")
        out[model] = (json.loads(path.read_text()), walls[model])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="pp", choices=sorted(MODELS))
    args = ap.parse_args()
    res = run(args.steps, args.frames, args.out, device=args.device,
              model=args.model)
    res["launches"] = launch_counts()
    line = json.dumps(res)
    print(line)
    if args.json:
        Path(args.json).write_text(line + "\n")
    ok = passed(res)
    print("PASS" if ok else "FAIL", (
        f"(every class's bev and 3d >= {ALL_FLOOR})" if args.model == "all"
        else "(targets: 3d >= 85, aos >= 80)"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
