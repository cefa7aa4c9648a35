"""Operations and bytes of the nuScenes multi-head network, counted from
the configuration's shapes and the reference's pillars (never from the
port), against the card's peaks in ``flops.py``.

Operations are 2 x multiply-adds. A request's network: the pillar
layer over the points the pillars hold, the backbone (``RPNNoHead``:
each stage's strided and plain 3x3 convs, its deblock), and the heads
(:func:`heads_ops`). The heads' least time (:func:`heads_bound_s`) is
the span ``net.heads``'s work: the larger of its operations at
PEAK_FLOPS and its bytes at PEAK_HBM_BYTES, the bytes being its inputs
(the cropped stage0 map and the deblocks' concatenation), its weights
and its concatenated preds, each moved once, in float32.
"""

import numpy as np

from .flops import PEAK_FLOPS, PEAK_HBM_BYTES

F32 = 4


def conv_ops(h, w, cin, cout, k):
    """A conv's operations for an [h, w] output."""
    return 2 * h * w * cin * cout * k * k


def _maps(model):
    """(stage0's [c, h, w], the cropped [h, w], the deblocks' [c, h, w])."""
    r = model["rpn"]
    _, h, w = model["grid_zyx"]
    s0 = None
    for i, s in enumerate(r["layer_strides"]):
        h, w = (h - 1) // s + 1, (w - 1) // s + 1
        if i == 0:
            s0 = (r["num_filters"][0], h, w)
    u = r["upsample_strides"][-1]  # the deblocks meet at the last's scale
    hu, wu = ((h * int(round(u)), w * int(round(u))) if u >= 1
              else (h // int(round(1 / u)), w // int(round(1 / u))))
    crop = int(np.round(s0[1] * model["heads"]["small_head"]["crop"]))
    return (s0, (s0[1] - 2 * crop, s0[2] - 2 * crop),
            (sum(r["num_upsample_filters"]), hu, wu))


def backbone_ops(model):
    """The backbone's operations on the [c, ny, nx] canvas."""
    r = model["rpn"]
    _, h, w = model["grid_zyx"]
    c, total = r["num_input_features"], 0
    for i, n in enumerate(r["layer_nums"]):
        s, nf = r["layer_strides"][i], r["num_filters"][i]
        h, w = (h - 1) // s + 1, (w - 1) // s + 1
        total += conv_ops(h, w, c, nf, 3) + n * conv_ops(h, w, nf, nf, 3)
        c = nf
        u, nu = r["upsample_strides"][i], r["num_upsample_filters"][i]
        if u >= 1:  # transposed: each input cell feeds u x u outputs
            total += conv_ops(h, w, c, nu, int(round(u)))
        else:
            k = int(round(1 / u))
            total += conv_ops(h // k, w // k, c, nu, k)
    return total


def _head_outputs(model):
    """Channels of a head's three 1x1 convs together."""
    return 7 + len(model["classes"]) + model["dir"]["bins"]


def heads_ops(model):
    """The small head's 3x3 stack and 1x1 convs on the cropped stage0
    map, and the large head's 1x1 convs on the deblocks' map."""
    (c0, _, _), (hs, ws), (cu, hu, wu) = _maps(model)
    small, large = model["heads"]["small_head"], model["heads"]["large_head"]
    out = _head_outputs(model)
    f = small["filters"]
    ops = conv_ops(hs, ws, c0, f, 3) + (small["conv_stack"] - 1) * conv_ops(
        hs, ws, f, f, 3)
    ops += conv_ops(hs, ws, f, small["anchors_per_loc"] * out, 1)
    ops += conv_ops(hu, wu, cu, large["anchors_per_loc"] * out, 1)
    return ops


def heads_bytes(model):
    """The heads' inputs, weights and concatenated preds, each once."""
    (c0, _, _), (hs, ws), (cu, hu, wu) = _maps(model)
    small, large = model["heads"]["small_head"], model["heads"]["large_head"]
    out = _head_outputs(model)
    f = small["filters"]
    inputs = c0 * hs * ws + cu * hu * wu
    stack = (c0 * f * 9 + (small["conv_stack"] - 1) * f * f * 9
             + small["conv_stack"] * 4 * f)  # convs and their norms
    ones = ((f + 1) * small["anchors_per_loc"] * out
            + (cu + 1) * large["anchors_per_loc"] * out)
    preds = (small["anchors_per_loc"] * hs * ws
             + large["anchors_per_loc"] * hu * wu) * out
    return F32 * (inputs + stack + ones + preds)


def heads_bound_s(model):
    """The heads' least time on the card, in seconds."""
    return max(heads_ops(model) / PEAK_FLOPS,
               heads_bytes(model) / PEAK_HBM_BYTES)


def request_ops(model, counts):
    """The operations of one request whose pillars hold ``counts``
    points (the reference's, capped at T)."""
    cin = model["num_point_features"] + 5 - 1  # radius replaces x, y
    pfn = 2 * int(np.sum(counts)) * cin * model["pfn_filters"]
    return pfn + backbone_ops(model) + heads_ops(model)
