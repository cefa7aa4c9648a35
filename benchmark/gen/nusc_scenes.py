"""nuScenes-statistics LiDAR frames, and the pool a nuScenes sweep mix
cycles through.

A frame is what ``NuScenesDataset.get_sensor_data`` hands a request: a
key frame and 9 earlier sweeps of a 32-beam lidar, accumulated in the key
frame's lidar coordinates, as float32 points [N, 4] (x, y, z, time lag
in s: 0 for the key frame, 0.05 s more for each earlier sweep), the key
frame's points first. Each sweep casts 32 rings x 1 085 azimuth steps
(the HDL-32E at 20 Hz); the rays that find no return within range are
lost, so a sweep holds ``points_per_sweep`` of those 34 720. The sensor
stood ``EGO_STEP`` m further back and turned by ``YAW_STEP`` more for
each earlier sweep (10 m/s at 20 Hz). The scene is static: the 23
beams below the horizon meet the road on rings about where the sensor
stood (3.1 to 79 m away), the 9 others meet facades 12-50 m away, and
boxes of every one of the 10 detection classes, sized as the
configuration's anchors (the nuScenes training set's box means), stand
among them, with points inside them in every sweep, fewer the further
they are. About 97% of the points lie within +-50 m in x and y, 85-87%
inside the configuration's range (facade returns above 3 m fall out).

The pool's sizes are the same set for every seed, in an order and with
contents drawn from the seed, so two seeds give the same amount of work.
"""

import numpy as np

# (w, l, h) and the z centre of each class, as the configuration's
# anchors give them, large classes first
CLASS_SIZES = (
    ((1.95017717, 4.60718145, 1.72270761), -0.93897414),
    ((2.4560939, 6.73778078, 2.73004906), -0.37937912),
    ((2.87427237, 12.01320693, 3.81509561), 0.22228277),
    ((2.94046906, 11.1885991, 3.47030982), -0.0715754),
    ((2.73050468, 6.38352896, 3.13312415), -0.08168083),
    ((0.66344886, 0.7256437, 1.75748069), -0.73911038),
    ((0.39694519, 0.40359262, 1.06232151), -1.27868911),
    ((0.60058911, 1.68452161, 1.27192197), -1.03743013),
    ((0.76279481, 2.09973778, 1.44403034), -0.99194854),
    ((2.49008838, 0.48578221, 0.98297065), -1.27247968),
)
RINGS = 32
STEPS = 1085  # azimuth steps a ring
SWEEPS = 10  # the key frame and 9 earlier sweeps
SWEEP_DT = 0.05  # s between sweeps (20 Hz)
EGO_STEP = 0.5  # m the sensor moves between sweeps (10 m/s)
YAW_STEP = 0.01  # rad it turns between sweeps
# the HDL-32E's beams, bottom to top
ELEVATION_DEG = np.linspace(-30.67, 10.67, RINGS)
LIDAR_HEIGHT = 1.84  # m above the road
FACADE_M = (12.0, 50.0)
FACADE_SECTORS = 24
HALF_RANGE = 45.0  # m, the objects' centres
MIN_GAP = 1.0  # m between the objects' circumcircles


def place_boxes(rng, per_class):
    """Boxes [M, 7] (x, y, z centre, w, l, h, yaw) and class ids [M] of
    ``per_class`` objects of each class, centred within HALF_RANGE m of
    the sensor and, as far as 200 draws each can manage, MIN_GAP m
    apart."""
    boxes, ids, circles = [], [], []
    for cls, (size, z) in enumerate(CLASS_SIZES):
        reach = 0.5 * float(np.hypot(size[0], size[1]))
        for _ in range(per_class):
            for _ in range(200):
                c = rng.uniform(-HALF_RANGE + reach, HALF_RANGE - reach, 2)
                if np.hypot(*c) > 3.0 + reach and all(
                        np.hypot(*(c - p)) >= reach + r + MIN_GAP
                        for p, r in circles):
                    break
            circles.append((c, reach))
            ids.append(cls)
            boxes.append([c[0], c[1], z, *size, rng.uniform(-np.pi, np.pi)])
    return np.array(boxes, np.float64), np.array(ids, np.int64)


def _object_points(rng, boxes):
    """Points uniform inside each box, ``clip(2000 / distance, 20, 300)``
    of them: [n, 3] float64."""
    dist = np.hypot(boxes[:, 0], boxes[:, 1])
    per = np.clip((2000.0 / dist).astype(np.int64), 20, 300)
    which = np.repeat(np.arange(len(boxes)), per)
    b = boxes[which]
    local = rng.uniform(-0.5, 0.5, (len(which), 3)) * b[:, 3:6]
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    x = local[:, 0] * c - local[:, 1] * s
    y = local[:, 0] * s + local[:, 1] * c
    return np.stack([x, y, local[:, 2]], 1) + b[:, :3]


def make_frame(rng, points_per_sweep, per_class):
    """(points [SWEEPS * points_per_sweep, 4] float32, boxes [M, 7],
    class ids [M]) of one frame."""
    boxes, ids = place_boxes(rng, per_class)
    # the beams below the horizon meet the road on rings about where the
    # sensor stood; the others meet facades, static in the key frame,
    # FACADE_M[0]-FACADE_M[1] m away in each of FACADE_SECTORS sectors
    elev = np.tan(np.deg2rad(ELEVATION_DEG))
    facade = rng.uniform(*FACADE_M, FACADE_SECTORS)
    sweeps = []
    for s in range(SWEEPS):
        origin = np.array([-EGO_STEP * s, 0.0])
        obj = _object_points(rng, boxes)
        # the rays that return: a random subset of the ring x azimuth
        # grid, the rest lost
        rays = rng.permutation(RINGS * STEPS)[:points_per_sweep - len(obj)]
        ring, step = rays // STEPS, rays % STEPS
        theta = (2 * np.pi * (step + rng.uniform(-0.1, 0.1, len(rays)))
                 / STEPS + YAW_STEP * s)
        t = elev[ring]
        ground = t < 0
        sector = (np.mod(theta, 2 * np.pi) / (2 * np.pi)
                  * FACADE_SECTORS).astype(np.int64) % FACADE_SECTORS
        dist = np.where(ground, -LIDAR_HEIGHT / np.minimum(t, -1e-6),
                        facade[sector])
        o = np.where(ground[:, None], origin[None, :], 0.0)
        hit = np.stack([o[:, 0] + dist * np.cos(theta),
                        o[:, 1] + dist * np.sin(theta),
                        np.where(ground, -LIDAR_HEIGHT, dist * t)
                        + rng.normal(0.0, 0.03, len(rays))], 1)
        xyz = np.concatenate([hit, obj])[rng.permutation(points_per_sweep)]
        lag = np.full((points_per_sweep, 1), SWEEP_DT * s)
        sweeps.append(np.concatenate([xyz, lag], 1))
    return np.concatenate(sweeps).astype(np.float32), boxes, ids


def pool_sizes(mix):
    """The (points per sweep, objects per class) of each frame of the
    pool, before the seed orders them: points evenly over
    ``mix["points_per_sweep"]`` (inclusive), objects cycling over
    ``mix["objects_per_class"]`` (inclusive)."""
    n = int(mix["pool"])
    lo, hi = mix["points_per_sweep"]
    o_lo, o_hi = mix["objects_per_class"]
    points = np.rint(np.linspace(lo, hi, n)).astype(int)
    objects = o_lo + np.arange(n) % (o_hi - o_lo + 1)
    return list(zip(points.tolist(), objects.tolist()))


def frame_pool(seed, mix):
    """The mix's pool of distinct frames (float32 [N, 4] arrays) from the
    seed: the sizes of :func:`pool_sizes` in a seeded order, each frame
    drawn from its own stream of the seed."""
    sizes = pool_sizes(mix)
    order = np.random.default_rng([seed, 0]).permutation(len(sizes))
    pool = []
    for i, j in enumerate(order):
        per_sweep, per_class = sizes[j]
        rng = np.random.default_rng([seed, 1, i])
        pool.append(make_frame(rng, per_sweep, per_class)[0])
    return pool
