"""Synthetic LiDAR scenes for tests and benchmarks.

There is no real KITTI data in CI; these helpers build plausible scenes
(ground plane + boxes with interior points). The port's copy of
``second_tpu/data/synthetic.py`` (less ``assemble_example``).
"""

import numpy as np

from ..core import box_ops


def make_kitti_scene(rng, num_cars=10, num_points=18000):
    """Deterministic KITTI-like velodyne_reduced scene.

    Matches the stats of a frustum-cropped KITTI cloud (~18k points in
    [0, 70.4] x [-40, 40]): a ground plane whose density falls off with
    range like spinning-LiDAR rings (~1/r), vertical clutter (poles,
    walls, vegetation), and car-shaped clusters — so voxel counts, the
    sparse active sets, and NMS load are representative.

    Returns (points [N, 4], gt_boxes [M, 7], gt_names [M]).
    """
    n_ground = int(num_points * 0.55)
    n_clutter = int(num_points * 0.30)

    # ground: sample range with p(r) ~ 1/r (ring spacing grows with r),
    # azimuth limited to the camera frustum (~±40 deg)
    u = rng.uniform(0, 1, n_ground)
    r = 3.0 * (70.4 / 3.0) ** u  # log-uniform in [3, 70.4]
    az = rng.uniform(-0.7, 0.7, n_ground)
    gx = r * np.cos(az)
    gy = r * np.sin(az)
    gz = rng.normal(-1.73, 0.03, n_ground) + 0.004 * r
    ground = np.stack([gx, gy, gz, rng.uniform(0, 1, n_ground)], axis=1)

    # clutter: vertical structures at random range (walls, poles, bushes)
    n_struct = 40
    cx = rng.uniform(5, 68, n_struct)
    cy = rng.uniform(-35, 35, n_struct)
    ch = rng.uniform(0.5, 3.0, n_struct)
    cw = rng.uniform(0.2, 4.0, n_struct)
    per = np.maximum(
        (n_clutter * (1.0 / np.hypot(cx, cy))
         / (1.0 / np.hypot(cx, cy)).sum()).astype(int), 1)
    clutter = []
    for i in range(n_struct):
        m = per[i]
        clutter.append(np.stack([
            rng.normal(cx[i], cw[i] * 0.3, m),
            rng.normal(cy[i], cw[i] * 0.3, m),
            rng.uniform(-1.7, -1.7 + ch[i], m),
            rng.uniform(0, 1, m),
        ], axis=1))
    clutter = np.concatenate(clutter)

    # cars: surface-ish point clusters, nearer cars denser
    gt_boxes = []
    car_pts = []
    for _ in range(num_cars):
        x = rng.uniform(6, 60)
        y = rng.uniform(-30, 30)
        z = rng.normal(-1.65, 0.05)
        l_, w_, h_ = (np.abs(rng.normal(3.9, 0.3)),
                      np.abs(rng.normal(1.6, 0.1)),
                      np.abs(rng.normal(1.56, 0.1)))
        yaw = rng.uniform(-np.pi, np.pi)
        gt_boxes.append([x, y, z, w_, l_, h_, yaw])
        m = int(np.clip(4000.0 / np.hypot(x, y), 30, 400))
        # points on the visible surfaces: sample the box faces
        local = rng.uniform([-w_ / 2, -l_ / 2, 0], [w_ / 2, l_ / 2, h_],
                            (m, 3))
        face = rng.randint(0, 3, m)
        local[face == 0, 0] = np.sign(local[face == 0, 0]) * w_ / 2
        local[face == 1, 1] = np.sign(local[face == 1, 1]) * l_ / 2
        local[face == 2, 2] = h_
        pts = box_ops.rotation_points_single_angle(
            local.astype(np.float64), -yaw, axis=2)
        pts[:, 0] += x
        pts[:, 1] += y
        pts[:, 2] += z
        car_pts.append(
            np.concatenate([pts, rng.uniform(0, 1, (m, 1))], axis=1))

    points = np.concatenate([ground, clutter] + car_pts).astype(np.float32)
    # frustum crop like velodyne_reduced
    keep = (
        (points[:, 0] > 0) & (points[:, 0] < 70.4)
        & (np.abs(points[:, 1]) < 40.0)
        & (np.abs(points[:, 1]) < points[:, 0] * 0.9 + 2.0)
    )
    points = points[keep]
    rng.shuffle(points)
    gt_boxes = np.array(gt_boxes, np.float32)
    names = np.array(["Car"] * num_cars)
    return points, gt_boxes, names
