"""Synthetic LiDAR scenes for tests and benchmarks.

There is no real KITTI data in CI; these helpers build plausible scenes
(ground plane + boxes with interior points). The port's copy of
``second_tpu/data/synthetic.py``: ``make_scene`` (``min_gap`` keeps the
objects apart, for the on-disk fixture of ``tools/kitti_fixture.py``;
``classes`` mixes KITTI classes), ``make_kitti_scene`` and
``assemble_example`` (the multi-rank dry run's batches).
"""

import numpy as np

from ..core import box_ops

# mean (w, l, h) of each KITTI class: all.fhd's anchor sizes
CLASS_SIZES = {
    "Car": (1.6, 3.9, 1.56),
    "Cyclist": (0.6, 1.76, 1.73),
    "Pedestrian": (0.6, 0.8, 1.73),
    "Van": (1.87103749, 5.02808195, 2.20964255),
}
# the spread of the sizes (w, l, h) around a car's mean
SIZE_STD = (0.1, 0.3, 0.1)


def make_scene(rng, num_objects=5, num_bg_points=8000,
               x_range=(0.0, 70.4), y_range=(-40.0, 40.0),
               points_per_object=120, size_mean=(1.6, 3.9, 1.56),
               min_gap=None, classes=None):
    """Returns (points [N, 4], gt_boxes [M, 7], gt_names [M]).

    min_gap: if set, rejection-sample object centers so no two are
    closer than this (meters) — physically-plausible non-overlapping
    boxes, which NMS and the KITTI matcher both assume.

    classes: optional {name: count} of ``CLASS_SIZES`` classes instead
    of ``num_objects`` cars of ``size_mean``; each object's size is drawn
    around its class's mean with the car's spread scaled to that mean.
    """
    if classes is not None:
        names = np.array([n for n, c in classes.items() for _ in range(c)])
        num_objects = len(names)
        means = np.array([CLASS_SIZES[n] for n in names]).reshape(-1, 3)
        size_std = np.asarray(SIZE_STD) * means / CLASS_SIZES["Car"]
    else:
        names = np.array(["Car"] * num_objects)
        means, size_std = size_mean, SIZE_STD
    if min_gap is not None:
        centers = []
        for _ in range(num_objects):
            for _ in range(200):
                cx = rng.uniform(x_range[0] + 5, x_range[1] - 5)
                cy = rng.uniform(y_range[0] + 5, y_range[1] - 5)
                if all(np.hypot(cx - px, cy - py) >= min_gap
                       for px, py in centers):
                    break
            centers.append((cx, cy))
        gx = np.array([c[0] for c in centers])
        gy = np.array([c[1] for c in centers])
    else:
        gx = rng.uniform(x_range[0] + 5, x_range[1] - 5, num_objects)
        gy = rng.uniform(y_range[0] + 5, y_range[1] - 5, num_objects)
    gz = rng.uniform(-1.8, -1.4, num_objects)
    sizes = np.abs(rng.normal(means, size_std, (num_objects, 3)))
    yaw = rng.uniform(-np.pi, np.pi, num_objects)
    gt_boxes = np.stack([gx, gy, gz, sizes[:, 0], sizes[:, 1], sizes[:, 2],
                         yaw], axis=1).astype(np.float32)

    bg = np.stack([
        rng.uniform(*x_range, num_bg_points),
        rng.uniform(*y_range, num_bg_points),
        rng.uniform(-2.0, -1.6, num_bg_points),
        rng.uniform(0, 1, num_bg_points),
    ], axis=1)

    obj_points = []
    for b in gt_boxes:
        local = rng.uniform(
            [-b[3] / 2, -b[4] / 2, 0], [b[3] / 2, b[4] / 2, b[5]],
            (points_per_object, 3))
        pts = box_ops.rotation_points_single_angle(
            local.astype(np.float64), -b[6], axis=2)
        pts[:, 0] += b[0]
        pts[:, 1] += b[1]
        pts[:, 2] += b[2]
        inten = rng.uniform(0, 1, (points_per_object, 1))
        obj_points.append(np.concatenate([pts, inten], axis=1))
    points = np.concatenate([bg] + obj_points).astype(np.float32)
    rng.shuffle(points)
    return points, gt_boxes, names


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


def assemble_example(parts, scenes, max_voxels=None):
    """scenes: list of (points, gt_boxes, gt_names) -> batched train
    example of host arrays (voxels, dense targets).

    Uses the built voxel_generator / target_assigner / anchor_cache of
    ``builders.network_builder.build_network``, mirroring
    prep_pointcloud's voxelize + assign steps (reference
    second/data/preprocess.py:302-408) with the fixed-shape padding
    contract.
    """
    gen = parts["voxel_generator"]
    ta = parts["target_assigner"]
    cache = parts["anchor_cache"]
    max_voxels = max_voxels or 12000
    b = len(scenes)
    t = gen.max_num_points_per_voxel
    anchors = cache["anchors"].astype(np.float32)
    a = anchors.shape[0]
    code = ta.box_coder.code_size
    nf = scenes[0][0].shape[1]

    ex = {
        "voxels": np.zeros((b, max_voxels, t, nf), np.float32),
        "num_points": np.zeros((b, max_voxels), np.int32),
        "coordinates": np.full((b, max_voxels, 3), -1, np.int32),
        "anchors": np.broadcast_to(anchors, (b, a, anchors.shape[1])).copy(),
        "labels": np.zeros((b, a), np.int32),
        "reg_targets": np.zeros((b, a, code), np.float32),
        "importance": np.ones((b, a), np.float32),
    }
    for i, (points, gt_boxes, gt_names) in enumerate(scenes):
        res = gen.generate_multi_gpu(points, max_voxels=max_voxels)
        n = res["voxel_num"]
        ex["voxels"][i] = res["voxels"]
        ex["num_points"][i] = res["num_points_per_voxel"]
        ex["coordinates"][i, :n] = res["coordinates"][:n]
        gt_classes = np.array(
            [ta.classes.index(name) + 1 for name in gt_names], np.int32)
        targets = ta.assign(
            anchors, cache["anchors_dict"], gt_boxes, anchors_mask=None,
            gt_classes=gt_classes, gt_names=list(gt_names),
            matched_thresholds=cache["matched_thresholds"],
            unmatched_thresholds=cache["unmatched_thresholds"])
        ex["labels"][i] = targets["labels"]
        ex["reg_targets"][i] = targets["bbox_targets"]
        if "importance" in targets:
            ex["importance"][i] = targets["importance"]
    return ex
