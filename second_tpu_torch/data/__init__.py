"""The host data pipeline of the port: the C++ voxelizer, preprocessing
and synthetic scenes (copies of the JAX package's framework-free numpy
and C++ in ``second_tpu/data``)."""

from .preprocess import merge_second_batch, prep_pointcloud  # noqa: F401
from .synthetic import make_kitti_scene  # noqa: F401
