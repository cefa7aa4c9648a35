"""Cut-down copies of the benchmark's configurations for CPU tests: the
published widths and topology on a small patch of ground, with the
port's text config rewritten to match."""

import copy
import re

import numpy as np

from benchmark import common

# (config, point cloud range, anchor range or offsets, post centre range,
# max voxels)
SMALL = {
    "car_fhd": dict(pc=[0, -3.2, -3, 6.4, 3.2, 1],
                    anchors=[0, -3.2, -1.0, 6.4, 3.2, -1.0],
                    post=[0, -3.2, -2.2, 6.4, 3.2, 0.8], voxels=3000),
    "pointpillars": dict(pc=[0, -10.24, -3, 20.48, 10.24, 1],
                         anchors=[0.16, -10.08, -1.78],
                         post=[0, -10.24, -5, 20.48, 10.24, 5],
                         voxels=2000),
}


def _fmt(v):
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def small_config(name, tmp_path):
    """(the benchmark's config dict cut to a small range, pointing at a
    rewritten copy of the port's text config under ``tmp_path``)."""
    cfg = copy.deepcopy(common.load_config(name))
    s = SMALL[name]
    m = cfg["model"]
    m["point_cloud_range"] = s["pc"]
    vs = m["voxel_size"]
    m["grid_zyx"] = [int(round((s["pc"][5 - a] - s["pc"][2 - a]) / vs[2 - a]))
                     for a in range(3)]
    m["post_center_range"] = s["post"]
    m["max_voxels"] = s["voxels"]
    if m["anchors"]["kind"] == "range":
        m["anchors"]["range"] = s["anchors"]
    else:
        m["anchors"]["offsets"] = s["anchors"]
    text = (common.ROOT / cfg["repo_config"]).read_text()
    text = re.sub(r"point_cloud_range\s*:\s*\[[^\]]*\]",
                  "point_cloud_range : " + _fmt(s["pc"]), text)
    text = re.sub(r"post_center_limit_range\s*:\s*\[[^\]]*\]",
                  "post_center_limit_range: " + _fmt(s["post"]), text)
    text = re.sub(r"anchor_ranges\s*:\s*\[[^\]]*\]",
                  "anchor_ranges: " + _fmt(s["anchors"]), text)
    text = re.sub(r"offsets\s*:\s*\[[^\]]*\]",
                  "offsets: " + _fmt(s["anchors"]), text)
    text = re.sub(r"max_number_of_voxels\s*:\s*\d+",
                  f"max_number_of_voxels: {s['voxels']}", text)
    path = tmp_path / f"{name}.config"
    path.write_text(text)
    cfg["repo_config"] = str(path)
    return cfg


def small_sweep(cfg, rng, n=3000):
    """Points over the small range: ground, a few boxes of clutter."""
    pc = np.asarray(cfg["model"]["point_cloud_range"])
    lo, hi = pc[:3], pc[3:]
    pts = rng.uniform(lo, hi, (n, 3))
    pts[: n // 2, 2] = rng.normal(-1.7, 0.05, n // 2)
    inten = rng.uniform(0, 1, (n, 1))
    return np.concatenate([pts, inten], 1).astype(np.float32)
