"""InputReader config -> the bound prep function and the dataset (twin of
``second_tpu/builders/dataset_builder.py``; reference
second/builder/dataset_builder.py:34-135).

A training reader whose ``database_sampler`` names a database or sample
groups gets the GT-database sampler (``dbsampler_builder``), as in the
JAX package; eval readers never do.
"""

from functools import partial

from ..configs import schema
from ..data import kitti_dataset, nuscenes_dataset  # noqa: F401 - registers
from ..data.dataset import get_dataset_class
from ..data.preprocess import prep_pointcloud
from ..models.sparse_middle import SPARSE_MIDDLE_NAMES, plan_scales
from . import dbsampler_builder


def points_capacity(input_reader_config: schema.InputReader):
    """The rows of the padded point buffer that the reader's examples
    ship (requests on the flat pillar path, and every point-shipping
    example): its dataset class's ``PointsCapacity``, 32768 for KITTI
    (also where the reader names no class, as a request's config may
    not) and 393216 for nuScenes' 10 accumulated sweeps. The JAX
    package's request path ships the first 32768 raw points for every
    dataset, so a nuScenes frame loses most of its points there."""
    name = input_reader_config.dataset.dataset_class_name or "KittiDataset"
    return get_dataset_class(name).PointsCapacity


def build_prep_func(input_reader_config: schema.InputReader, parts,
                    training, emit_points=0, compact_targets=False):
    """``prep_pointcloud`` bound to the reader's preprocess settings and
    the network ``parts`` of ``build_network``; sparse middles get the
    host rulebooks (``sparse_plan_scales`` at the reader's voxel
    capacity) unless the example ships points (``emit_points`` > 0: the
    device builds the rulebooks, and no planner runs), dense ones none;
    a training reader that names a GT-database sampler gets it.
    ``emit_points`` and ``compact_targets`` as ``prep_pointcloud`` takes
    them."""
    prep_cfg = input_reader_config.preprocess
    sampler_cfg = prep_cfg.database_sampler
    db_sampler = None
    if training and (len(sampler_cfg.sample_groups) > 0
                     or sampler_cfg.database_info_path != ""):
        if prep_cfg.groundtruth_points_drop_percentage > 0:
            # the JAX package takes the option and never reads it
            raise NotImplementedError(
                "groundtruth_points_drop_percentage > 0 is implemented in "
                "neither package (ROADMAP.md, 'Raising by design')")
        db_sampler = dbsampler_builder.build(sampler_cfg)
    model_cfg = parts["model_cfg"]
    middle_name = model_cfg.middle_feature_extractor.module_class_name
    sparse_plan_scales = None
    if middle_name in SPARSE_MIDDLE_NAMES and not emit_points:
        sparse_plan_scales = plan_scales(
            middle_name, parts["dense_shape"], prep_cfg.max_number_of_voxels)
    return partial(
        prep_pointcloud,
        root_path=input_reader_config.dataset.kitti_root_path,
        voxel_generator=parts["voxel_generator"],
        target_assigner=parts["target_assigner"],
        training=training,
        max_voxels=prep_cfg.max_number_of_voxels,
        remove_outside_points=False,
        remove_unknown=prep_cfg.remove_unknown_examples,
        create_targets=training,
        shuffle_points=prep_cfg.shuffle_points,
        # eval configs leave the noise fields unset (empty lists); they
        # are only consumed when training=True
        gt_rotation_noise=(
            list(prep_cfg.groundtruth_rotation_uniform_noise) or [0.0, 0.0]),
        gt_loc_noise_std=(
            list(prep_cfg.groundtruth_localization_noise_std) or [0.0] * 3),
        global_rotation_noise=(
            list(prep_cfg.global_rotation_uniform_noise) or [0.0, 0.0]),
        global_scaling_noise=(
            list(prep_cfg.global_scaling_uniform_noise) or [1.0, 1.0]),
        global_random_rot_range=(
            list(prep_cfg.global_random_rotation_range_per_object)
            or [0.0, 0.0]),
        global_translate_noise_std=(
            list(prep_cfg.global_translate_noise_std) or [0.0] * 3),
        db_sampler=db_sampler,
        num_point_features=model_cfg.num_point_features,
        anchor_area_threshold=prep_cfg.anchor_area_threshold,
        remove_points_after_sample=prep_cfg.remove_points_after_sample,
        remove_environment=prep_cfg.remove_environment,
        use_group_id=prep_cfg.use_group_id,
        out_size_factor=parts["out_size_factor"],
        min_points_in_gt=prep_cfg.min_num_of_points_in_gt,
        random_flip_x=prep_cfg.random_flip_x,
        random_flip_y=prep_cfg.random_flip_y,
        sample_importance=prep_cfg.sample_importance,
        anchor_cache=parts["anchor_cache"],
        sparse_plan_scales=sparse_plan_scales,
        emit_points=emit_points,
        compact_targets=compact_targets,
    )


def build(input_reader_config: schema.InputReader, parts, training,
          device_voxelize=False):
    """The reader's dataset (its ``dataset_class_name``: ``KittiDataset``
    or the nuScenes family) with its bound prep function.

    device_voxelize: ship the in-range points (``points_capacity`` rows)
    instead of the padded voxel buffer; the step voxelizes on the
    device, and a sparse middle builds its rulebooks there (no host
    planner runs: the JAX package's route without its planner). In
    training such examples also carry compact targets (int8 labels and
    the positive anchors' rows), as the JAX package's ``build`` defaults
    them. Otherwise the examples ship host voxels, and for a sparse
    middle the host plan.
    """
    dataset_cfg = input_reader_config.dataset
    model_cfg = parts["model_cfg"]
    dataset_cls = get_dataset_class(dataset_cfg.dataset_class_name)
    assert dataset_cls.NumPointFeatures == model_cfg.num_point_features
    prep_func = build_prep_func(
        input_reader_config, parts, training,
        emit_points=(points_capacity(input_reader_config)
                     if device_voxelize else 0),
        compact_targets=bool(device_voxelize) and training)
    return dataset_cls(
        info_path=dataset_cfg.kitti_info_path,
        root_path=dataset_cfg.kitti_root_path,
        class_names=list(parts["target_assigner"].classes),
        prep_func=prep_func,
    )
