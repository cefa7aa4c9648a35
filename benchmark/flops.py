"""Peaks of the card, and the operations and bytes of the work a request
needs, counted from the configuration's shapes and from the active sets
and rulebooks the reference builds from the voxel coordinates (never
from the port's outputs), so the same work reads the same whatever
implements it.

PEAK_FLOPS is the 3xTF32 rate, 495 / 3 TFLOP/s: the fastest at which an
H100 SXM gives fp32-accurate products, and the rate K1 runs at, so no
fp32 path can read over 100%. The plain fp32 rate (67 TFLOP/s) is beside
it for reference.
"""

import torch

from .reference import nets, sparse

PEAK_TF32_FLOPS = 495e12
PEAK_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def rpn_flops(model, c, h, w):
    """2 x multiply-adds of RPNV2 on a [c, h, w] map: per stage the
    strided 3x3 conv, ``layer_nums`` 3x3 convs, the transposed-conv
    deblock, then the three 1x1 heads."""
    r = model["rpn"]
    total, ups = 0, 0
    for i, n in enumerate(r["layer_nums"]):
        s, nf = r["layer_strides"][i], r["num_filters"][i]
        h, w = (h - 1) // s + 1, (w - 1) // s + 1
        total += 2 * h * w * nf * c * 9
        total += n * 2 * h * w * nf * nf * 9
        c = nf
        u, nu = r["upsample_strides"][i], r["num_upsample_filters"][i]
        total += 2 * h * w * c * nu * u * u
        ups += nu
        hu, wu = h * u, w * u
    per_loc = model["anchors"]["per_loc"]
    heads = per_loc * (7 + 1 + model["dir"]["bins"])
    return total + 2 * hu * wu * ups * heads


def middle_work(model, coords, device):
    """Each conv of the sparse middle on these voxel coords [V, 3] (zyx):
    {pairs, vin, vout, cin, cout, k}, from the reference's rulebooks."""
    nz, ny, nx = model["grid_zyx"]
    shape = (1, nz + 1, ny, nx)
    idx = torch.as_tensor(coords, device=device).long()
    idx = torch.cat([torch.zeros_like(idx[:, :1]), idx], 1)
    lin = torch.sort(sparse.to_lin(idx, shape)).values
    cin = model["num_point_features"]
    work, rows = [], None
    for op in model["middle_topology"]:
        kernel = (1,) + nets._t3(op[2])
        vin = lin.shape[0]
        if op[0] == "subm":
            if rows is None or rows.shape[0] != vin:
                rows = sparse.subm_rulebook(lin, shape, kernel)
            r = rows
        else:
            lin, shape, r = sparse.down_rulebook(
                lin, shape, kernel, (1,) + nets._t3(op[3]),
                (0,) + nets._t3(op[4]))
            rows = None
        k = 1
        for x in kernel:
            k *= x
        work.append({"pairs": sparse.pairs(r, vin), "vin": vin,
                     "vout": r.shape[0], "cin": cin, "cout": op[1], "k": k})
        cin = op[1]
    return work, shape


def conv_bound_s(cw):
    """Least time of one sparse conv on the card: each input (features,
    weights, rulebook) read once and the output written once at HBM
    bandwidth, or 2 x pairs x Cin x Cout operations at PEAK_FLOPS,
    whichever is longer."""
    nbytes = 4 * (cw["vin"] * cw["cin"] + cw["k"] * cw["cin"] * cw["cout"]
                  + cw["vout"] * cw["k"] + cw["vout"] * cw["cout"])
    ops = 2 * cw["pairs"] * cw["cin"] * cw["cout"]
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_FLOPS)


def request_work(model, coords, counts, device):
    """(operations of one request's network, K1's least time in seconds)
    for a request whose voxels are at ``coords`` with ``counts`` points."""
    if model["network"] == "second":
        work, shape = middle_work(model, coords, device)
        ops = sum(2 * c["pairs"] * c["cin"] * c["cout"] for c in work)
        c = model["middle_topology"][-1][1] * shape[1]
        ops += rpn_flops(model, c, shape[2], shape[3])
        k1 = sum(conv_bound_s(c) for c in work[:model["k1_convs"]])
        return ops, k1
    _, ny, nx = model["grid_zyx"]
    f = model["pfn_filters"]
    ops = 2 * int(counts.sum()) * (model["num_point_features"] + 5) * f
    return ops + rpn_flops(model, f, ny, nx), 0.0
