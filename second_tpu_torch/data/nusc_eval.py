"""Subprocess entry for the official NuScenes eval (reference
second/data/nusc_eval.py) — isolated so devkit memory is released.
The port's copy of ``second_tpu/data/nusc_eval.py``; it needs the
nuscenes devkit."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def eval_main(root_path, version, eval_version, res_path, eval_set,
              output_dir):
    from nuscenes import NuScenes
    from nuscenes.eval.detection.config import config_factory
    from nuscenes.eval.detection.evaluate import NuScenesEval

    nusc = NuScenes(version=version, dataroot=str(root_path), verbose=False)
    cfg = config_factory(eval_version)
    nusc_eval = NuScenesEval(
        nusc,
        config=cfg,
        result_path=res_path,
        eval_set=eval_set,
        output_dir=output_dir,
        verbose=False,
    )
    nusc_eval.main(render_curves=False)


if __name__ == "__main__":
    from second_tpu_torch.utils.fire_lite import fire

    fire(eval_main)
