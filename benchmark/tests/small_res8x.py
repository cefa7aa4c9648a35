"""The nuScenes residual sparse configuration cut for CPU tests: its
published widths, topology, classes and 0.1 x 0.1 x 0.2 m voxels on a
+-3.2 m patch (a [41, 64, 64] grid, an [8, 8] BEV map with every
class's anchors on [1, 8, 8]), 4 000 voxels; the port's text config
rewritten to match; and frames of points for it."""

import copy

import numpy as np

from benchmark import common

R = 3.2  # m: 64 cells of 0.1 m a side
VOXELS = 4000


def small_res8x_config(tmp_path):
    """(the benchmark's ``nusc_res8x`` config dict on the +-R m patch of
    the module's docstring, pointing at a rewritten copy of the port's
    text config under ``tmp_path``)."""
    from second_tpu_torch.configs import load_pipeline_config

    cfg = copy.deepcopy(common.load_config("nusc_res8x"))
    m = cfg["model"]
    pc = [-R, -R, -5.0, R, R, 3.0]
    post = [-R - 2, -R - 2, -10.0, R + 2, R + 2, 10.0]
    n = int(round(2 * R / m["voxel_size"][0]))
    fms = [1, n // 8, n // 8]
    m.update(point_cloud_range=pc, grid_zyx=[40, n, n], max_voxels=VOXELS,
             post_center_range=post)
    text = load_pipeline_config(str(common.ROOT / cfg["repo_config"]))
    sec = text.model.second
    sec.voxel_generator.point_cloud_range = pc
    sec.post_center_limit_range = post
    text.eval_input_reader.preprocess.max_number_of_voxels = VOXELS
    for c, s in zip(m["classes"], sec.target_assigner.class_settings):
        c["range"] = [-R, -R, c["range"][2], R, R, c["range"][5]]
        c["feature_map_size"] = fms
        s.anchor_generator_range.anchor_ranges = c["range"]
        s.feature_map_size = fms
    path = tmp_path / "all.res8x.config"
    path.write_text(text.to_text())
    cfg["repo_config"] = str(path)
    return cfg


def small_res8x_frame(rng, n=6000):
    """Points [n, 4] (x, y, z, time lag) around the patch: half a ground
    at the sensor's height, a quarter in three object-sized clusters, a
    quarter clutter, some outside the range."""
    lo, hi = np.array([-R - 1, -R - 1, -5.0]), np.array([R + 1, R + 1, 3.0])
    pts = rng.uniform(lo, hi, (n, 3))
    pts[: n // 2, 2] = rng.normal(-1.84, 0.05, n // 2)
    q = n // 4
    centres = rng.uniform(-R, R, (3, 3))
    centres[:, 2] = rng.uniform(-1.5, 0.0, 3)
    pts[n // 2:n // 2 + q] = (centres[rng.integers(0, 3, q)]
                              + rng.uniform(-0.6, 0.6, (q, 3)))
    lag = rng.integers(0, 10, (n, 1)) * 0.05
    return np.concatenate([pts, lag], 1).astype(np.float32)
