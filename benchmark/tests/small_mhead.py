"""The nuScenes multi-head configuration cut for CPU tests: its published
widths, topology and classes on a +-12.5 m patch (a 100 x 100 pillar
grid at the published 0.25 m), every class's feature map cut by 4 with
it (large [1, 25, 25] over +-12.5 m, small [1, 80, 80] over +-10 m, the
cropped stage0), 3 000 pillars; the port's text config rewritten to
match."""

import copy

import numpy as np

from benchmark import common

R = 12.5
SMALL_R = 10.0
VOXELS = 3000


def small_mhead_config(tmp_path):
    """(the benchmark's ``nusc_mhead`` config dict cut as above, pointing
    at a rewritten copy of the port's text config under ``tmp_path``)."""
    from second_tpu_torch.configs import load_pipeline_config

    cfg = copy.deepcopy(common.load_config("nusc_mhead"))
    m = cfg["model"]
    pc = [-R, -R, -5.0, R, R, 3.0]
    post = [-R - 2, -R - 2, -10.0, R + 2, R + 2, 10.0]
    m["point_cloud_range"] = pc
    n = int(round(2 * R / m["voxel_size"][0]))
    m["grid_zyx"] = [1, n, n]
    m["max_voxels"] = VOXELS
    m["post_center_range"] = post
    text = load_pipeline_config(str(common.ROOT / cfg["repo_config"]))
    sec = text.model.second
    sec.voxel_generator.point_cloud_range = pc
    sec.post_center_limit_range = post
    text.eval_input_reader.preprocess.max_number_of_voxels = VOXELS
    for c, s in zip(m["classes"], sec.target_assigner.class_settings):
        large = c["feature_map_size"][1] == 100
        r = R if large else SMALL_R
        k = n // 4 if large else n - 2 * (n // 10)
        fms = [1, k, k]
        c["range"] = [-r, -r, c["range"][2], r, r, c["range"][5]]
        c["feature_map_size"] = fms
        s.anchor_generator_range.anchor_ranges = c["range"]
        s.feature_map_size = fms
    path = tmp_path / "nusc_mhead.config"
    path.write_text(text.to_text())
    cfg["repo_config"] = str(path)
    return cfg


def small_frame(cfg, rng, n=6000):
    """Points [n, 4] (x, y, z, time lag) over the small range: a ground,
    boxes of clutter, a tenth outside the range."""
    pc = np.asarray(cfg["model"]["point_cloud_range"])
    lo, hi = pc[:3] - [2, 2, 0], pc[3:] + [2, 2, 0]
    pts = rng.uniform(lo, hi, (n, 3))
    pts[: n // 2, 2] = rng.normal(-1.84, 0.05, n // 2)
    lag = rng.integers(0, 10, (n, 1)) * 0.05
    return np.concatenate([pts, lag], 1).astype(np.float32)
