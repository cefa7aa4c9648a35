"""Synthetic on-disk KITTI mini-dataset (the port's copy of the JAX
package's test fixture ``tests/kitti_fixture.py``): a ``training/`` tree
of velodyne bins, label files, calibs and blank PNGs, for the train and
evaluate entry points and ``tools/overfit_ap.py``."""

import struct
import zlib
from pathlib import Path

import numpy as np

from ..core import box_ops
from ..data import kitti_common as kitti
from ..data.synthetic import make_scene

# a KITTI-plausible calibration: camera looks along lidar +x
TR_VELO_TO_CAM = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, -0.08],
    [1.0, 0.0, 0.0, -0.27],
    [0.0, 0.0, 0.0, 1.0],
])
R0_RECT = np.eye(4)
P2 = np.array([
    [721.54, 0.0, 609.56, 44.85],
    [0.0, 721.54, 172.85, 0.2163],
    [0.0, 0.0, 1.0, 0.0027],
    [0.0, 0.0, 0.0, 1.0],
])
IMAGE_SHAPE = (375, 1242)  # h, w


def _write_png(path, h, w):
    """Minimal valid PNG with the given dimensions (1-bit gray rows)."""
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)

    def chunk(typ, data):
        c = typ + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c))

    raw = zlib.compress(b"".join(b"\x00" + b"\x80" * w for _ in range(h)), 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", raw))
        f.write(chunk(b"IEND", b""))


def make_scene_lidar(rng, num_cars=4, num_bg_points=6000,
                     points_per_object=200,
                     x_range=(5.0, 60.0), y_range=(-20.0, 20.0),
                     min_gap=None, classes=None):
    """lidar-frame scene with cars (or the {name: count} ``classes`` of
    ``data.synthetic.CLASS_SIZES``) in front of the camera (x > 5)."""
    points, gt_boxes, names = make_scene(
        rng, num_objects=num_cars, num_bg_points=num_bg_points,
        x_range=x_range, y_range=y_range,
        points_per_object=points_per_object, min_gap=min_gap,
        classes=classes)
    return points, gt_boxes, names


def lidar_box_to_label_lines(gt_boxes_bottom, names, points):
    """lidar z-BOTTOM boxes -> KITTI label file lines."""
    cam = box_ops.box_lidar_to_camera(
        gt_boxes_bottom, R0_RECT, TR_VELO_TO_CAM)
    bboxes = box_ops.box3d_to_bbox(
        gt_boxes_bottom, R0_RECT, TR_VELO_TO_CAM, P2)
    bboxes[:, 0] = np.clip(bboxes[:, 0], 0, IMAGE_SHAPE[1])
    bboxes[:, 1] = np.clip(bboxes[:, 1], 0, IMAGE_SHAPE[0])
    bboxes[:, 2] = np.clip(bboxes[:, 2], 0, IMAGE_SHAPE[1])
    bboxes[:, 3] = np.clip(bboxes[:, 3], 40, IMAGE_SHAPE[0])  # eval-able
    lines = []
    for i, name in enumerate(names):
        x, y, z, l, h, w, ry = cam[i]
        alpha = -np.arctan2(-gt_boxes_bottom[i, 1], gt_boxes_bottom[i, 0]) + ry
        b = bboxes[i]
        lines.append(
            f"{name} 0.00 0 {alpha:.2f} "
            f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
            f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
    return lines


def build_kitti_dir(root, num_frames=4, seed=0, scene_kwargs=None):
    """Create a fake KITTI training tree; returns frame ids.

    scene_kwargs: forwarded to make_scene_lidar (e.g. KITTI-scale
    density: num_cars=10, num_bg_points=16000; the four KITTI classes:
    classes={"Car": 6, "Cyclist": 2, "Pedestrian": 3, "Van": 1})."""
    root = Path(root)
    for sub in ("velodyne", "label_2", "calib", "image_2"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = list(range(num_frames))
    calib_lines = []
    for name, mat in [("P0", P2), ("P1", P2), ("P2", P2), ("P3", P2)]:
        calib_lines.append(
            name + ": " + " ".join(f"{v:.12e}" for v in mat[:3].ravel()))
    calib_lines.append(
        "R0_rect: " + " ".join(f"{v:.12e}" for v in R0_RECT[:3, :3].ravel()))
    calib_lines.append(
        "Tr_velo_to_cam: "
        + " ".join(f"{v:.12e}" for v in TR_VELO_TO_CAM[:3].ravel()))
    calib_lines.append(
        "Tr_imu_to_velo: "
        + " ".join(f"{v:.12e}" for v in np.eye(4)[:3].ravel()))
    calib_str = "\n".join(calib_lines) + "\n"
    for idx in ids:
        stem = kitti.get_image_index_str(idx)
        points, gt_boxes_center, names = make_scene_lidar(
            rng, **(scene_kwargs or {}))
        # label files carry z-BOTTOM camera boxes
        gt_bottom = gt_boxes_center.copy()
        points.astype(np.float32).tofile(
            str(root / "training" / "velodyne" / f"{stem}.bin"))
        with open(root / "training" / "label_2" / f"{stem}.txt", "w") as f:
            f.write("\n".join(
                lidar_box_to_label_lines(gt_bottom, names, points)) + "\n")
        with open(root / "training" / "calib" / f"{stem}.txt", "w") as f:
            f.write(calib_str)
        _write_png(
            root / "training" / "image_2" / f"{stem}.png", *IMAGE_SHAPE)
    return ids
