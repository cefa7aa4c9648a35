"""The route of an example: what a host example ships and how the device
turns it into the network's input, decided once, by :func:`make_route`,
for a request (``core.inference.InferenceContext``), a training loader
or an evaluation loader.

There are four routes:

* host voxels with the C++ planner's ``plan_*`` rulebooks: the loaders'
  route for sparse middles;
* host voxels sorted by linear id, with the rulebooks built on the
  device (``models.sparse_middle.build_device_plan``): a sparse
  middle's requests;
* host voxels through the network's modules: dense middles on host
  voxels;
* the in-range points, padded to the reader's ``points_capacity`` rows
  (``data.preprocess.pad_points``), which the device voxelizes
  (:func:`make_voxelizer_fn`), or pillarizes on the flat pillar path
  (``models.pp_fast``) where a PillarFeatureNet encoder on a dense
  middle serves requests or evaluations.

The host half: ``builders.dataset_builder.build_prep_func`` binds
``prep_pointcloud`` to a route, and :meth:`Route.sort_request` sorts a
request's voxels. The device half: :func:`network_inputs` and
:func:`infer`, which ``InferenceContext`` and the train and eval steps
of ``train.state`` share.
"""

import contextlib
import dataclasses
import functools

import torch

from ..configs import schema
from ..data import kitti_dataset, nuscenes_dataset  # noqa: F401 - registers
from ..data.dataset import get_dataset_class
from ..data.preprocess import sort_by_linear_id
from ..models.pp_fast import pointpillars_infer
from ..models.sparse_middle import SPARSE_MIDDLE_NAMES, plan_scales
from ..models.voxelnet import predict
from ..ops.voxelize import voxelize
from ..utils import timer

USES = ("request", "train", "eval")


def points_capacity(input_reader_config: schema.InputReader):
    """The rows of the padded point buffer that the reader's examples
    ship on a points route: its dataset class's ``PointsCapacity``,
    32768 for KITTI (also where the reader names no class, as a
    request's config may not) and 393216 for nuScenes' 10 accumulated
    sweeps. The JAX package's request path ships the first 32768 raw
    points for every dataset, so a nuScenes frame loses most of its
    points there."""
    name = input_reader_config.dataset.dataset_class_name or "KittiDataset"
    return get_dataset_class(name).PointsCapacity


@dataclasses.dataclass(frozen=True, eq=False)
class Route:
    """One route of the module's docstring, built by :func:`make_route`.

    ships_points: the example ships "points" [points_capacity, F] and
        "points_count" instead of "voxels", "num_points" and
        "coordinates". Such a route voxelizes on the host only where
        the reader sets an anchor mask (``anchor_area_threshold >= 0``,
        PointPillars), whose summed-area table reads the host voxels'
        coordinates; its example keeps "num_voxels". Without the mask
        nothing reads host voxels, so ``prep_pointcloud`` makes none and
        the example ships no "num_voxels".
    flat_pp: the device runs the flat pillar path on those points.
    plan_scales: ``models.sparse_middle.plan_scales`` where the example
        carries the C++ planner's rulebooks, else None.
    sort_shape: the (D, H, W) grid by whose linear ids a request sorts
        its voxels, where the device builds their rulebooks; else None.
    compact_targets: a training example ships its targets compact
        (``prep_pointcloud``'s ``compact_targets``).
    points_capacity: the rows of the padded point buffer
        (:func:`points_capacity`).
    max_voxels: the reader's voxel capacity, the host voxelizer's and
        the device's.
    gen: the network's voxel generator.
    """

    ships_points: bool
    flat_pp: bool
    plan_scales: list | None
    sort_shape: tuple | None
    compact_targets: bool
    points_capacity: int
    max_voxels: int
    gen: object = dataclasses.field(repr=False)

    @functools.cached_property
    def voxelizer(self):
        """The device voxelizer of the route's points (None on voxels)."""
        if not self.ships_points:
            return None
        return make_voxelizer_fn(self.gen, self.max_voxels)

    def sort_request(self, example):
        """Sort a request's voxels by linear id in place, under
        "prep.plan", where the device builds their rulebooks."""
        if self.sort_shape is not None:
            with timer.span("prep.plan"):
                sort_by_linear_id(example, self.sort_shape)


def make_route(parts, input_reader_config, use, device_voxelize=False):
    """The route of ``use``'s examples ("request", "train" or "eval") on
    the network ``parts`` of ``build_network``, at the capacities of
    the input reader ``input_reader_config``.

    device_voxelize True ships the in-range points: the device
    voxelizes them, and a sparse middle builds its rulebooks there.
    False ships host voxels: a sparse middle's loaders carry the C++
    planner's rulebooks, and its requests sort their voxels for the
    device's planner. "auto" takes each use's default: a training
    loader ships points for dense middles, an evaluation loader for
    PointPillars networks (a PillarFeatureNet on a dense middle), and a
    request takes "auto" as True. Whatever it is given, a PointPillars
    request ships points and runs the flat pillar path; so does an
    evaluation on points. A training step runs the network's modules.
    """
    if use not in USES:
        raise ValueError(f"use must be one of {USES}, not {use!r}")
    if device_voxelize != "auto" and not isinstance(device_voxelize, bool):
        raise ValueError(f"device_voxelize must be 'auto', True or False, "
                         f"not {device_voxelize!r}")
    model_cfg = parts["model_cfg"]
    middle = model_cfg.middle_feature_extractor.module_class_name
    sparse = middle in SPARSE_MIDDLE_NAMES
    vfe = model_cfg.voxel_feature_extractor.module_class_name
    pillars = not sparse and vfe.startswith("PillarFeatureNet")
    if device_voxelize == "auto":
        device_voxelize = {"request": True, "train": not sparse,
                           "eval": pillars}[use]
    ships_points = device_voxelize or (use == "request" and pillars)
    max_voxels = input_reader_config.preprocess.max_number_of_voxels
    scales = (plan_scales(middle, parts["dense_shape"], max_voxels)
              if sparse and not ships_points else None)
    request = use == "request"
    return Route(
        ships_points=ships_points,
        flat_pp=pillars and ships_points and use != "train",
        plan_scales=None if request else scales,
        sort_shape=scales[0]["shape"] if request and scales else None,
        compact_targets=ships_points and use == "train",
        points_capacity=points_capacity(input_reader_config),
        max_voxels=max_voxels, gen=parts["voxel_generator"])


def make_voxelizer_fn(voxel_generator, max_voxels):
    """The device voxelizer of point-shipping examples: maps a padded
    point batch ("points" [B, N, F] + "points_count" [B, 1]) to
    (voxels [B, V, T, F], num_points [B, V], coordinates [B, V, 3]),
    frame by frame through ``ops.voxelize.voxelize`` (the twin of the
    host C++ voxelizer), with no host sync. The generator's
    ``full_empty_part_with_mean`` (its ``_full_mean``) fills each
    voxel's empty slots with its mean, as the host voxelizer does; the
    JAX package's function reads a ``full_mean`` attribute the generator
    does not have, and never fills them (``ROADMAP.md`` section 3)."""
    full_mean = bool(voxel_generator._full_mean)
    voxel_size = tuple(float(v) for v in voxel_generator.voxel_size)
    range_min = tuple(
        float(v) for v in voxel_generator.point_cloud_range[:3])
    grid = tuple(int(v) for v in voxel_generator.grid_size)
    t = int(voxel_generator.max_num_points_per_voxel)

    def fn(points, points_count):
        frames = [voxelize(p, c[0], voxel_size, range_min, grid,
                           int(max_voxels), t, full_mean)
                  for p, c in zip(points, points_count)]
        voxels, coords, counts, _ = zip(*frames)
        return torch.stack(voxels), torch.stack(counts), torch.stack(coords)

    return fn


def plan_of(example):
    """The example's host plan, or None where it ships none (the JAX
    package's ``plan or None``): a sparse middle then builds its
    rulebooks on the device."""
    return {k: v for k, v in example.items() if k.startswith("plan_")} or None


def network_inputs(route, example):
    """(voxels, num_points, coordinates) of a device batch: those the
    device voxelizer makes of its points where ``route`` ships points,
    else its host voxels (also where ``route`` is None)."""
    if route is not None and route.ships_points:
        return route.voxelizer(example["points"], example["points_count"])
    return (example["voxels"], example["num_points"],
            example["coordinates"])


def infer(route, net, spec, example):
    """A device batch -> (the network's preds, ``predict``'s fixed-size
    detections, a sparse middle's stage counts [B, S, 2] on the device,
    else None), without gradients and in the network's current mode:
    the flat pillar path where ``route`` runs it, else the network's
    modules on :func:`network_inputs` and the example's host plan
    (:func:`plan_of`; a sparse middle without one builds its rulebooks
    on the device). ``route`` None: host voxels."""
    if route is not None and route.flat_pp:
        return pointpillars_infer(net, spec, example, gen=route.gen,
                                  max_voxels=route.max_voxels) + (None,)
    inter = {}
    # the device voxelizer is the first part of the encoder's stage; the
    # VFE's span follows it
    voxelizing = route is not None and route.ships_points
    with torch.no_grad():
        with (timer.span("net.encode") if voxelizing
              else contextlib.nullcontext()):
            voxels, num_points, coords = network_inputs(route, example)
        preds = net(voxels, num_points, coords, plan_of(example), inter)
        dets = predict(spec, preds, example)
    return preds, dets, inter.get("sparse_active_counts")
