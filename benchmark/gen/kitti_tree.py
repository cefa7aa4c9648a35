"""An on-disk KITTI training tree of the benchmark's sweeps, a frozen
copy of the port's ``tools.kitti_fixture.build_kitti_dir`` (velodyne
bins, label files, calibrations, blank images) writing
:func:`scenes.make_kitti_scene` sweeps, with the box arithmetic its
label lines need."""

import struct
import zlib
from pathlib import Path

import numpy as np

from .scenes import make_kitti_scene, pool_sizes

# a KITTI-plausible calibration: the camera looks along lidar +x
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
_CORNERS3D = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
                       [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0]],
                      np.float64)


def _write_png(path, h, w):
    """A minimal valid grey PNG of the given size."""
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


def _lidar_to_camera(xyz):
    pts = np.concatenate([xyz, np.ones_like(xyz[:, :1])], 1)
    return (pts @ (R0_RECT @ TR_VELO_TO_CAM).T)[:, :3]


def _box3d_to_bbox(cam):
    """Camera boxes [x, y, z, l, h, w, ry] (bottom centre) -> image
    bboxes [N, 4] (the projection ignores P2's translation column, as
    the published code does)."""
    dims = cam[:, 3:6]
    corners = dims[:, None, :] * (_CORNERS3D - np.array([0.5, 1.0, 0.5]))
    s, c = np.sin(cam[:, 6]), np.cos(cam[:, 6])
    one, zero = np.ones_like(c), np.zeros_like(c)
    rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    rot = np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)
    corners = np.einsum("npj,njk->npk", corners, rot) + cam[:, None, :3]
    pts4 = np.concatenate([corners, np.zeros_like(corners[..., :1])], -1)
    img = pts4 @ P2.T
    img = img[..., :2] / img[..., 2:3]
    return np.concatenate([img.min(1), img.max(1)], 1)


def label_lines(gt_boxes, names):
    """lidar boxes [x, y, z (bottom), w, l, h, yaw] -> KITTI label
    lines."""
    xyz = _lidar_to_camera(gt_boxes[:, :3])
    w, l, h, r = (gt_boxes[:, i:i + 1] for i in (3, 4, 5, 6))
    cam = np.concatenate([xyz, l, h, w, r], 1)
    bboxes = _box3d_to_bbox(cam)
    bboxes[:, 0] = np.clip(bboxes[:, 0], 0, IMAGE_SHAPE[1])
    bboxes[:, 1] = np.clip(bboxes[:, 1], 0, IMAGE_SHAPE[0])
    bboxes[:, 2] = np.clip(bboxes[:, 2], 0, IMAGE_SHAPE[1])
    bboxes[:, 3] = np.clip(bboxes[:, 3], 40, IMAGE_SHAPE[0])
    lines = []
    for i, name in enumerate(names):
        x, y, z, l_, h_, w_, ry = cam[i]
        alpha = -np.arctan2(-gt_boxes[i, 1], gt_boxes[i, 0]) + ry
        b = bboxes[i]
        lines.append(
            f"{name} 0.00 0 {alpha:.2f} "
            f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
            f"{h_:.2f} {w_:.2f} {l_:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
    return lines


def build_kitti_dir(root, seed, mix):
    """A ``training/`` tree of ``mix["frames"]`` sweeps (the sizes of
    :func:`scenes.pool_sizes` in a seeded order); returns the frame
    ids."""
    root = Path(root)
    for sub in ("velodyne", "label_2", "calib", "image_2"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    sizes = pool_sizes(dict(mix, pool=mix["frames"]))
    order = np.random.default_rng([seed, 4]).permutation(len(sizes))
    calib = []
    for name in ("P0", "P1", "P2", "P3"):
        calib.append(name + ": " + " ".join(f"{v:.12e}"
                                            for v in P2[:3].ravel()))
    calib.append("R0_rect: " + " ".join(f"{v:.12e}"
                                        for v in R0_RECT[:3, :3].ravel()))
    calib.append("Tr_velo_to_cam: " + " ".join(
        f"{v:.12e}" for v in TR_VELO_TO_CAM[:3].ravel()))
    calib.append("Tr_imu_to_velo: " + " ".join(
        f"{v:.12e}" for v in np.eye(4)[:3].ravel()))
    calib = "\n".join(calib) + "\n"
    ids = list(range(len(sizes)))
    for idx, j in zip(ids, order):
        stem = f"{idx:06d}"
        num_points, num_cars = sizes[j]
        rng = np.random.RandomState(
            np.random.SeedSequence([seed, 5, idx]).generate_state(1)[0])
        points, gt_boxes, names = make_kitti_scene(rng, num_cars, num_points)
        points.astype(np.float32).tofile(
            str(root / "training" / "velodyne" / f"{stem}.bin"))
        with open(root / "training" / "label_2" / f"{stem}.txt", "w") as f:
            f.write("\n".join(label_lines(gt_boxes, names)) + "\n")
        with open(root / "training" / "calib" / f"{stem}.txt", "w") as f:
            f.write(calib)
        _write_png(root / "training" / "image_2" / f"{stem}.png",
                   *IMAGE_SHAPE)
    return ids
