"""VoxelGenerator from proto config (reference
second/builder/voxel_builder.py:7-33).

The port's copy of ``second_tpu/builders/voxel_builder.py``."""

from ..configs import schema
from ..data.voxelizer import VoxelGenerator


def build(voxel_config: schema.VoxelGenerator) -> VoxelGenerator:
    return VoxelGenerator(
        voxel_size=list(voxel_config.voxel_size),
        point_cloud_range=list(voxel_config.point_cloud_range),
        max_num_points=voxel_config.max_number_of_points_per_voxel,
        max_voxels=20000,
        full_mean=voxel_config.full_empty_part_with_mean,
        block_filtering=voxel_config.block_filtering,
        block_factor=voxel_config.block_factor,
        block_size=voxel_config.block_size,
        height_threshold=voxel_config.height_threshold,
    )
