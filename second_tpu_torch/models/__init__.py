"""The port's model zoo; importing it registers every ported module."""

from . import middle, rpn, sparse_middle, voxel_encoders, voxelnet  # noqa: F401
from .registry import (  # noqa: F401
    get_middle_class,
    get_rpn_class,
    get_vfe_class,
    get_voxelnet_class,
)
