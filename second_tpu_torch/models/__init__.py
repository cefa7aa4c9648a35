"""The port's model zoo; importing it registers every ported module."""

from . import (  # noqa: F401
    middle,
    multi_head,
    rpn,
    sparse_middle,
    voxel_encoders,
    voxelnet,
)
from .registry import (  # noqa: F401
    get_middle_class,
    get_rpn_class,
    get_vfe_class,
    get_voxelnet_class,
)
