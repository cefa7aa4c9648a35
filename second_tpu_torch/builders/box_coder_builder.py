"""Box coder from proto config (reference
second/pytorch/builder/box_coder_builder.py:8-28).

The port's copy of ``second_tpu/builders/box_coder_builder.py``."""

from ..configs import schema
from ..core.box_coders import BevBoxCoder, GroundBox3dCoder


def build(box_coder_config: schema.BoxCoder):
    which = box_coder_config.WhichOneof("box_coder")
    if which == "ground_box3d_coder":
        cfg = box_coder_config.ground_box3d_coder
        return GroundBox3dCoder(cfg.linear_dim, cfg.encode_angle_vector)
    if which == "bev_box_coder":
        cfg = box_coder_config.bev_box_coder
        return BevBoxCoder(
            cfg.linear_dim, cfg.encode_angle_vector, cfg.z_fixed, cfg.h_fixed
        )
    raise ValueError("empty box coder config")
