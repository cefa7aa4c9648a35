"""KITTI-statistics LiDAR sweeps, a frozen copy of the port's
``data.synthetic.make_kitti_scene`` (with its rotation helper), and the
pool of sweeps a sweep mix cycles through.

The pool's sizes are the same set for every seed, in an order and with
contents drawn from the seed, so two seeds give the same amount of work.
"""

import numpy as np


def _rotate_z(points, angle):
    """Rotate [N, 3] float64 points by a scalar angle about z (the port's
    ``box_ops.rotation_points_single_angle(points, angle, axis=2)``)."""
    s, c = np.sin(angle), np.cos(angle)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return points @ rot


def make_kitti_scene(rng, num_cars=10, num_points=18000):
    """A frustum-cropped KITTI-like sweep: a ground plane whose density
    falls off with range like spinning-LiDAR rings, vertical clutter, and
    car-shaped clusters. Returns (points [N, 4] float32, gt_boxes [M, 7],
    gt_names [M])."""
    n_ground = int(num_points * 0.55)
    n_clutter = int(num_points * 0.30)

    u = rng.uniform(0, 1, n_ground)
    r = 3.0 * (70.4 / 3.0) ** u  # log-uniform in [3, 70.4]
    az = rng.uniform(-0.7, 0.7, n_ground)
    gx = r * np.cos(az)
    gy = r * np.sin(az)
    gz = rng.normal(-1.73, 0.03, n_ground) + 0.004 * r
    ground = np.stack([gx, gy, gz, rng.uniform(0, 1, n_ground)], axis=1)

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
        local = rng.uniform([-w_ / 2, -l_ / 2, 0], [w_ / 2, l_ / 2, h_],
                            (m, 3))
        face = rng.randint(0, 3, m)
        local[face == 0, 0] = np.sign(local[face == 0, 0]) * w_ / 2
        local[face == 1, 1] = np.sign(local[face == 1, 1]) * l_ / 2
        local[face == 2, 2] = h_
        pts = _rotate_z(local.astype(np.float64), -yaw)
        pts[:, 0] += x
        pts[:, 1] += y
        pts[:, 2] += z
        car_pts.append(
            np.concatenate([pts, rng.uniform(0, 1, (m, 1))], axis=1))

    points = np.concatenate([ground, clutter] + car_pts).astype(np.float32)
    keep = (
        (points[:, 0] > 0) & (points[:, 0] < 70.4)
        & (np.abs(points[:, 1]) < 40.0)
        & (np.abs(points[:, 1]) < points[:, 0] * 0.9 + 2.0)
    )
    points = points[keep]
    rng.shuffle(points)
    gt_boxes = np.array(gt_boxes, np.float32).reshape(-1, 7)
    names = np.array(["Car"] * num_cars)
    return points, gt_boxes, names


def pool_sizes(mix):
    """The (points, cars) of each sweep of the pool, before the seed
    orders them: points evenly over ``mix["points"]`` (inclusive), cars
    cycling over ``mix["cars"]`` (inclusive)."""
    n = int(mix["pool"])
    lo, hi = mix["points"]
    c_lo, c_hi = mix["cars"]
    points = np.rint(np.linspace(lo, hi, n)).astype(int)
    cars = c_lo + np.arange(n) % (c_hi - c_lo + 1)
    return list(zip(points.tolist(), cars.tolist()))


def sweep_pool(seed, mix):
    """The mix's pool of distinct sweeps (float32 [N, 4] arrays) from the
    seed: the sizes of :func:`pool_sizes` in a seeded order, each scene
    drawn from its own stream of the seed."""
    sizes = pool_sizes(mix)
    order = np.random.default_rng([seed, 0]).permutation(len(sizes))
    pool = []
    for i, j in enumerate(order):
        num_points, num_cars = sizes[j]
        rng = np.random.RandomState(
            np.random.SeedSequence([seed, 1, i]).generate_state(1)[0])
        pool.append(make_kitti_scene(rng, num_cars, num_points)[0])
    return pool
