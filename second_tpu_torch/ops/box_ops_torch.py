"""PyTorch twins of the device box math (``second_tpu/ops/box_ops_jax.py``).

Same formulas; they run on the device inside the port's predict.
"""

import math

import torch


def second_box_decode(encodings, anchors, encode_angle_to_vector=False,
                      smooth_dim=False):
    """[..., code] residuals + [..., 7+] anchors -> [..., 7+] boxes."""
    ndim = anchors.shape[-1]
    xa, ya, za, wa, la, ha, ra = (anchors[..., i:i + 1] for i in range(7))
    xt, yt, zt, wt, lt, ht = (encodings[..., i:i + 1] for i in range(6))
    diag = torch.sqrt(wa ** 2 + la ** 2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    if smooth_dim:
        wg, lg, hg = (wt + 1) * wa, (lt + 1) * la, (ht + 1) * ha
    else:
        wg, lg, hg = torch.exp(wt) * wa, torch.exp(lt) * la, torch.exp(ht) * ha
    if encode_angle_to_vector:
        rtx, rty = encodings[..., 6:7], encodings[..., 7:8]
        rg = torch.atan2(rty + torch.sin(ra), rtx + torch.cos(ra))
        rest = encodings[..., 8:ndim + 1]
    else:
        rg = encodings[..., 6:7] + ra
        rest = encodings[..., 7:ndim]
    custom = [rest + anchors[..., 7:ndim]] if ndim > 7 else []
    return torch.cat([xg, yg, zg, wg, lg, hg, rg, *custom], dim=-1)


def bev_box_decode(encodings, anchors, encode_angle_to_vector=False,
                   smooth_dim=False):
    """[..., 5] residuals ([..., 6] with the angle as a vector) + [..., 5]
    (x, y, w, l, r) anchors -> [..., 5] BEV boxes."""
    xa, ya, wa, la, ra = (anchors[..., i:i + 1] for i in range(5))
    xt, yt, wt, lt = (encodings[..., i:i + 1] for i in range(4))
    diag = torch.sqrt(wa ** 2 + la ** 2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    if smooth_dim:
        wg, lg = (wt + 1) * wa, (lt + 1) * la
    else:
        wg, lg = torch.exp(wt) * wa, torch.exp(lt) * la
    if encode_angle_to_vector:
        rtx, rty = encodings[..., 4:5], encodings[..., 5:6]
        rg = torch.atan2(rty + torch.sin(ra), rtx + torch.cos(ra))
    else:
        rg = encodings[..., 4:5] + ra
    return torch.cat([xg, yg, wg, lg, rg], dim=-1)


def limit_period(val, offset=0.5, period=math.pi):
    return val - torch.floor(val / period + offset) * period


def box_to_corners(boxes):
    """[..., 5] (x, y, w, l, angle) -> [..., 4, 2] corners, in the ring
    order and rotation convention of ``second_tpu.core.rotated_iou``."""
    x, y, w, l, ang = boxes.unbind(-1)
    c, s = torch.cos(ang), torch.sin(ang)
    dx = torch.stack([-w, -w, w, w], dim=-1) * 0.5
    dy = torch.stack([-l, l, l, -l], dim=-1) * 0.5
    cx = dx * c[..., None] + dy * s[..., None] + x[..., None]
    cy = -dx * s[..., None] + dy * c[..., None] + y[..., None]
    return torch.stack([cx, cy], dim=-1)


def corner_to_standup(corners):
    """[N, 4, 2] -> [N, 4] xyxy."""
    return torch.cat([corners.amin(dim=-2), corners.amax(dim=-2)], dim=-1)
