"""InputReader config -> the bound prep function (the part of
``second_tpu/builders/dataset_builder.py`` that needs no dataset on
disk; reference second/builder/dataset_builder.py:34-135).

The GT-database sampler and the dataset classes are not ported yet: a
config with a database sampler runs without it.
"""

from functools import partial

from ..configs import schema
from ..data.preprocess import prep_pointcloud
from ..models.sparse_middle import SPARSE_MIDDLE_NAMES, plan_scales


def build_prep_func(input_reader_config: schema.InputReader, parts,
                    training):
    """``prep_pointcloud`` bound to the reader's preprocess settings and
    the network ``parts`` of ``build_network``; sparse middles get the
    host rulebooks (``sparse_plan_scales`` at the reader's voxel
    capacity)."""
    prep_cfg = input_reader_config.preprocess
    model_cfg = parts["model_cfg"]
    middle_name = model_cfg.middle_feature_extractor.module_class_name
    if middle_name not in SPARSE_MIDDLE_NAMES:
        raise NotImplementedError(f"middle {middle_name!r} is not ported yet")
    return partial(
        prep_pointcloud,
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
        num_point_features=model_cfg.num_point_features,
        anchor_area_threshold=prep_cfg.anchor_area_threshold,
        remove_environment=prep_cfg.remove_environment,
        use_group_id=prep_cfg.use_group_id,
        out_size_factor=parts["out_size_factor"],
        min_points_in_gt=prep_cfg.min_num_of_points_in_gt,
        random_flip_x=prep_cfg.random_flip_x,
        random_flip_y=prep_cfg.random_flip_y,
        anchor_cache=parts["anchor_cache"],
        sparse_plan_scales=plan_scales(
            middle_name, parts["dense_shape"],
            prep_cfg.max_number_of_voxels),
    )
