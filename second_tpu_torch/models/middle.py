"""Dense middle feature extractors (twin of ``second_tpu/models/middle.py``):
pillar features -> the BEV pseudo-image, NCHW ([B, C, ny, nx]) as the
port's RPN takes it (the JAX package's is NHWC). The sparse-conv
middles are in ``sparse_middle.py``.
"""

import torch
from torch import nn

from .registry import register_middle


def scatter_canvas(features, coords, ny, nx):
    """features [B, V, C] and coords [B, V, 3] int zyx with -1 padding
    rows -> the canvas [B, C, ny, nx], zero where no pillar is. Padding
    rows write nowhere: each gets a slot of its own past the canvas, so
    every index of the scatter is unique."""
    b, v, c = features.shape
    coords = coords.long()
    flat = torch.where(
        coords[..., 0] >= 0, coords[..., 1] * nx + coords[..., 2],
        ny * nx + torch.arange(v, device=coords.device))
    canvas = features.new_zeros(b, c, ny * nx + v)
    canvas.scatter_(2, flat[:, None, :].expand(b, c, v),
                    features.transpose(1, 2))
    return canvas[:, :, :ny * nx].reshape(b, c, ny, nx)


@register_middle
class PointPillarsScatter(nn.Module):
    """Scatter pillar features onto the BEV canvas (reference
    pointpillars.py:420-476), through :func:`scatter_canvas`."""

    def __init__(self, output_shape, num_input_features=64,
                 num_filters_down1=(), num_filters_down2=(), use_norm=True):
        # output_shape [1, nz, ny, nx, C]; the other arguments are the
        # middles' common signature (a scatter has no weights to norm)
        super().__init__()
        self.ny, self.nx = int(output_shape[2]), int(output_shape[3])

    def forward(self, features, coords):
        return scatter_canvas(features, coords, self.ny, self.nx)
