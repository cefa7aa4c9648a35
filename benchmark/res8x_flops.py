"""Operations and least times of the nuScenes residual network, counted
from the configuration's shapes and the reference's rulebooks (never
from the port), against the card's peaks in ``flops.py``.

Operations are 2 x multiply-adds: each sparse conv's rulebook hits x
Cin x Cout (``reference.res8x.work``), then the BEV neck (RPNV2's
stages and deblocks) and its 1x1 head on the [C * D, H, W] map. K1's
least time is ``flops.conv_bound_s`` summed over every sparse conv; the
wide stage's, over the convs with more than 64 output channels (conv4,
its blocks and conv_out: the span ``net.middle.wide``'s K1 launches).
"""

from .flops import conv_bound_s
from .reference import res8x

NARROW_MAX = 64


def neck_ops(model, c, h, w):
    """RPNV2 on a [c, h, w] map: per stage the strided 3x3 conv,
    ``layer_nums`` 3x3 convs and the transposed-conv deblock, then the
    1x1 head (per anchor 7 box numbers, a logit per class, the direction
    logits)."""
    r = model["rpn"]
    total, ups = 0, 0
    for i, n in enumerate(r["layer_nums"]):
        s, nf = r["layer_strides"][i], r["num_filters"][i]
        h, w = (h - 1) // s + 1, (w - 1) // s + 1
        total += 2 * h * w * nf * c * 9 + n * 2 * h * w * nf * nf * 9
        c = nf
        u, nu = r["upsample_strides"][i], r["num_upsample_filters"][i]
        total += 2 * h * w * c * nu * u * u
        ups += nu
        hu, wu = h * u, w * u
    out = r["anchors_per_loc"] * (7 + len(model["classes"])
                                  + model["dir"]["bins"])
    return total + 2 * hu * wu * ups * out


def request_work(model, scales):
    """(operations of one request's network, K1's least time, the wide
    stage's least time, both in seconds) on the reference's rulebooks
    ``scales`` (``res8x.plan``)."""
    convs = res8x.work(model, scales)
    ops = sum(2 * c["pairs"] * c["cin"] * c["cout"] for c in convs)
    _, d, h, w = scales[-1]["shape"]
    ops += neck_ops(model, model["middle_topology"][-1][1] * d, h, w)
    k1 = sum(conv_bound_s(c) for c in convs)
    wide = sum(conv_bound_s(c) for c in convs if c["cout"] > NARROW_MAX)
    return ops, k1, wide
