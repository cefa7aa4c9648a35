"""Synthetic on-disk nuScenes-format tree, made from a seed, for the
train and evaluate entry points, ``InferenceContext`` and the GT
database on ``data.nuscenes_dataset.NuScenesDataset`` (no devkit
needed).

    from second_tpu_torch.tools.nusc_fixture import build_nusc_dir
    info_path = build_nusc_dir(root, num_frames=8)

Each frame is a key frame and ``sweeps`` earlier sweeps, each a ``.bin``
of 5 float32 per point (x, y, z, intensity 0-255, ring), as the
nuScenes lidar writes them. The scene is static in the key frame's
lidar coordinates: a ground of ``rings`` rings around the sensor (each
sweep's rings centred on where the sensor stood, ``EGO_STEP`` m behind
per sweep, with a small yaw) and boxes of every one of the 10 detection
classes (``CLASS_SIZES``, the box means the published config's anchors
use) with points inside them in every sweep. Each sweep is written in
its own lidar frame, and the info carries the rotation and translation
that take it back to the key frame, as ``create_nuscenes_infos`` writes
them. The info's ``num_lidar_pts`` counts the key frame's points in
each box. ``points_per_sweep`` 34 720 (32 rings x 1 085 azimuth steps)
is the HDL-32E's sweep, so 9 sweeps give nuScenes' density.
"""

import pickle
from pathlib import Path

import numpy as np

from ..core import box_ops

# (w, l, h) and the z centre of each class, the published config's
# anchors (the nuScenes training set's box means), large classes first
CLASS_SIZES = {
    "car": ((1.95017717, 4.60718145, 1.72270761), -0.93897414),
    "truck": ((2.4560939, 6.73778078, 2.73004906), -0.37937912),
    "trailer": ((2.87427237, 12.01320693, 3.81509561), 0.22228277),
    "bus": ((2.94046906, 11.1885991, 3.47030982), -0.0715754),
    "construction_vehicle": ((2.73050468, 6.38352896, 3.13312415),
                             -0.08168083),
    "pedestrian": ((0.66344886, 0.7256437, 1.75748069), -0.73911038),
    "traffic_cone": ((0.39694519, 0.40359262, 1.06232151), -1.27868911),
    "bicycle": ((0.60058911, 1.68452161, 1.27192197), -1.03743013),
    "motorcycle": ((0.76279481, 2.09973778, 1.44403034), -0.99194854),
    "barrier": ((2.49008838, 0.48578221, 0.98297065), -1.27247968),
}
GROUND_Z = -1.84  # the lidar's height above the road, negated
EGO_STEP = 0.5  # m the sensor moves forward between sweeps (10 m/s, 20 Hz)
SWEEP_DT = 0.05  # s between sweeps


def place_boxes(rng, objects_per_class, half_range, min_gap=1.0):
    """Boxes [M, 7] (lidar, z at the centre) and names of
    ``objects_per_class`` objects of each class, their centres within
    ``half_range`` m of the sensor and (as far as 200 draws each can
    manage) their footprints' circumcircles ``min_gap`` m apart."""
    names, boxes, circles = [], [], []
    for name, (size, z) in CLASS_SIZES.items():
        reach = 0.5 * float(np.hypot(size[0], size[1]))
        for _ in range(objects_per_class):
            for _ in range(200):
                c = rng.uniform(-half_range + reach, half_range - reach, 2)
                if np.hypot(*c) > 3.0 + reach and all(
                        np.hypot(*(c - p)) >= reach + r + min_gap
                        for p, r in circles):
                    break
            circles.append((c, reach))
            names.append(name)
            boxes.append([c[0], c[1], z, *size, rng.uniform(-np.pi, np.pi)])
    return np.array(boxes, np.float64), np.array(names)


def _ground(rng, n, rings, origin, yaw, max_radius):
    """``n`` points on ``rings`` rings about ``origin`` (key-frame xy),
    their radii growing geometrically from 2.5 m to ``max_radius``."""
    ring = rng.randint(0, rings, n)
    radius = 2.5 * (max_radius / 2.5) ** (ring / max(rings - 1, 1))
    theta = rng.uniform(-np.pi, np.pi, n) + yaw
    xyz = np.stack([origin[0] + radius * np.cos(theta),
                    origin[1] + radius * np.sin(theta),
                    GROUND_Z + rng.normal(0.0, 0.03, n)], 1)
    return xyz, ring


def _object_points(rng, boxes, per_object):
    """``per_object`` points uniform inside each box."""
    out = []
    for b in boxes:
        w, l, h = b[3:6]
        local = rng.uniform([-w / 2, -l / 2, -h / 2], [w / 2, l / 2, h / 2],
                            (per_object, 3))
        # the sense in which box_ops.points_in_rbbox turns a box
        pts = box_ops.rotation_points_single_angle(local, b[6], axis=2)
        out.append(pts + b[:3])
    return np.concatenate(out) if out else np.zeros((0, 3))


def _write(path, xyz, ring, rng):
    pts = np.concatenate([xyz, rng.uniform(0, 255, (len(xyz), 1)),
                          ring.reshape(-1, 1)], 1).astype(np.float32)
    pts.tofile(str(path))


def build_nusc_dir(root, num_frames=8, seed=0, sweeps=9,
                   points_per_sweep=34720, rings=32, objects_per_class=1,
                   points_per_object=60, half_range=40.0, max_radius=70.0,
                   version="v1.0-trainval"):
    """Write the tree under ``root``: ``samples/LIDAR_TOP``,
    ``sweeps/LIDAR_TOP`` and ``infos_train.pkl`` (``infos_val.pkl`` holds
    the same frames). Returns the train info path.

    Each sweep holds ``points_per_sweep`` points: ``points_per_object``
    in each box (``objects_per_class`` boxes of every class, centred
    within ``half_range`` m), the rest on the rings (out to
    ``max_radius`` m)."""
    root = Path(root)
    key_dir = root / "samples" / "LIDAR_TOP"
    sweep_dir = root / "sweeps" / "LIDAR_TOP"
    key_dir.mkdir(parents=True, exist_ok=True)
    sweep_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    infos = []
    for i in range(num_frames):
        boxes, names = place_boxes(rng, objects_per_class, half_range)
        n_obj = len(boxes) * points_per_object
        ts = int(1e6 * (1000 + 10 * i))
        sweep_infos, num_lidar_pts = [], None
        for s in range(sweeps + 1):
            # where the sensor stood, in the key frame's lidar coordinates
            t = np.array([-EGO_STEP * s, 0.0, 0.0])
            yaw = 0.01 * s
            c, sn = np.cos(yaw), np.sin(yaw)
            rot = np.array([[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]])
            ground, ring = _ground(rng, points_per_sweep - n_obj, rings,
                                   t, yaw, max_radius)
            obj = _object_points(rng, boxes, points_per_object)
            xyz = np.concatenate([ground, obj])
            ring = np.concatenate([ring, rng.randint(0, rings, len(obj))])
            if s == 0:
                num_lidar_pts = box_ops.points_in_rbbox(
                    xyz, boxes).sum(0).astype(np.int64)
                path = key_dir / f"{i:06d}.bin"
                _write(path, xyz, ring, rng)
                continue
            # the sweep's own frame: p_key = rot @ p_sweep + t
            path = sweep_dir / f"{i:06d}_{s:02d}.bin"
            _write(path, (xyz - t) @ rot, ring, rng)
            sweep_infos.append({
                "lidar_path": str(path),
                "sample_data_token": f"sd{i}_{s}",
                "timestamp": ts - int(1e6 * SWEEP_DT * s),
                "sweep2lidar_rotation": rot,
                "sweep2lidar_translation": t,
            })
        infos.append({
            "lidar_path": str(key_dir / f"{i:06d}.bin"),
            "cam_front_path": str(root / "samples" / "CAM_FRONT"
                                  / f"{i:06d}.jpg"),
            "token": f"sample{i:04d}",
            "sweeps": sweep_infos,
            "lidar2ego_translation": [0.0, 0.0, 1.84],
            "lidar2ego_rotation": [1.0, 0.0, 0.0, 0.0],
            "ego2global_translation": [100.0 * i, 0.0, 0.0],
            "ego2global_rotation": [1.0, 0.0, 0.0, 0.0],
            "timestamp": ts,
            "gt_boxes": boxes,
            "gt_names": names,
            "gt_velocity": np.zeros((len(boxes), 2)),
            "num_lidar_pts": num_lidar_pts,
            "num_radar_pts": np.zeros(len(boxes), np.int64),
        })
    data = {"infos": infos, "metadata": {"version": version}}
    for split in ("train", "val"):
        with open(root / f"infos_{split}.pkl", "wb") as f:
            pickle.dump(data, f)
    return root / "infos_train.pkl"
