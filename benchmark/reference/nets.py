"""The two networks' forward passes in plain PyTorch, from the
benchmark's weights (keyed by the port's parameter names, which is how
the same tensors reach both) and the configuration's sizes.

``bn`` is the eval-mode batch norm of the layer ``name`` (eps 1e-3); the
weight maker passes a calibrating one. Each forward returns the preds
{box_preds [B, A, 7], cls_preds [B, A, 1], dir_cls_preds [B, A, 2]}
with anchors ordered (anchor type, y, x), a list of each sparse conv's
work, and the heads' input.
"""

import torch
import torch.nn.functional as F

from . import sparse

EPS = 1e-3


def eval_bn(w, name, x, channel_dim, rows=None):
    """``rows``: the rows of a 2-D ``x`` that hold data (a calibrating
    norm reads its statistics there; this one ignores it)."""
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    inv = torch.reciprocal(torch.sqrt(w[name + ".running_var"] + EPS))
    y = (x - w[name + ".running_mean"].view(shape)) * inv.view(shape)
    return y * w[name + ".weight"].view(shape) + w[name + ".bias"].view(shape)


def train_bn(w, name, x, channel_dim, rows=None):
    """Training-mode batch norm: the batch's statistics (biased
    variance, two passes) over every row of ``x`` but the channels."""
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
    mean = x.mean(dims)
    var = torch.square(x - mean.view(shape)).mean(dims)
    inv = torch.reciprocal(torch.sqrt(var + EPS))
    y = (x - mean.view(shape)) * inv.view(shape)
    return y * w[name + ".weight"].view(shape) + w[name + ".bias"].view(shape)


def _t3(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * 3


def sparse_middle(w, model, coords, feats, batch=1, bn=eval_bn):
    """The SECOND middle over the voxels (coords [V, 4] batch, z, y, x;
    features [V, C]) -> the BEV map [B, C*D, H, W] (channel c*D + d) and
    each conv's work: dicts of pairs, vin, vout, cin, cout, k."""
    nz, ny, nx = model["grid_zyx"]
    shape = (batch, nz + 1, ny, nx)
    lin = sparse.to_lin(coords.long(), shape)
    order = torch.argsort(lin)
    lin, feats = lin[order], feats[order]
    work = []
    prefix = "middle_feature_extractor."
    subm_rows = None
    for li, op in enumerate(model["middle_topology"]):
        kind, cout, kernel = op[0], op[1], (1,) + _t3(op[2])
        weight = w[f"{prefix}{kind}{li}_w"]
        vin = lin.shape[0]
        if kind == "subm":
            if subm_rows is None:
                subm_rows = sparse.subm_rulebook(lin, shape, kernel)
            rows = subm_rows
        else:
            lin, shape, rows = sparse.down_rulebook(
                lin, shape, kernel, (1,) + _t3(op[3]), (0,) + _t3(op[4]))
            subm_rows = None
        out = sparse.gather_conv(feats, rows, weight)
        work.append({"pairs": sparse.pairs(rows, vin), "vin": vin,
                     "vout": rows.shape[0], "cin": weight.shape[1],
                     "cout": cout, "k": weight.shape[0]})
        feats = torch.relu(bn(w, f"{prefix}bn{li}", out, -1))
    b, d, h, wd = shape
    c = feats.shape[1]
    dense = feats.new_zeros(c, b * d * h * wd)
    dense = dense.index_copy(1, lin, feats.t())
    dense = dense.view(c, b, d, h, wd).permute(1, 0, 2, 3, 4)
    return dense.reshape(b, c * d, h, wd), work


def rpn(w, model, x, bn=eval_bn):
    """RPNV2: per stage a strided 3x3 conv and ``layer_nums`` 3x3 convs,
    each conv + BN + ReLU, a transposed-conv deblock per stage, the
    deblocks concatenated, then 1x1 heads."""
    r = model["rpn"]
    li = 0
    ups = []

    def cbr(x, stride, transpose):
        nonlocal li
        name = f"rpn.layers.{li}"
        weight = w[name + ".conv.weight"]
        if transpose:
            y = F.conv_transpose2d(x, weight, stride=stride)
        else:
            y = F.conv2d(x, weight, stride=stride, padding=1)
        li += 1
        return torch.relu(bn(w, name + ".bn", y, 1))

    for i, n in enumerate(r["layer_nums"]):
        x = cbr(x, r["layer_strides"][i], False)
        for _ in range(n):
            x = cbr(x, 1, False)
        ups.append(cbr(x, r["upsample_strides"][i], True))
    x = torch.cat(ups, 1)
    nloc = model["anchors"]["per_loc"]

    def head(name, size):
        y = F.conv2d(x, w[f"rpn.{name}.weight"], w[f"rpn.{name}.bias"])
        b, _, h, wd = y.shape
        return y.view(b, nloc, size, h, wd).permute(0, 1, 3, 4, 2).reshape(
            b, -1, size)

    return {"box_preds": head("conv_box", 7),
            "cls_preds": head("conv_cls", 1),
            "dir_cls_preds": head("conv_dir_cls", model["dir"]["bins"])}, x


def second(w, model, coords, counts, voxels, bn=eval_bn):
    """car.fhd: the mean of each voxel's points, the sparse middle, the
    RPN. ``coords`` [V, 3] (one frame) or [V, 4] with the frame first."""
    nf = model["num_point_features"]
    feats = voxels[..., :nf].sum(1) / counts.clamp(min=1)[:, None].to(
        voxels.dtype)
    if coords.shape[1] == 3:
        coords = torch.cat([torch.zeros_like(coords[:, :1]), coords], 1)
    batch = int(coords[:, 0].max()) + 1 if len(coords) else 1
    bev, work = sparse_middle(w, model, coords, feats, batch, bn)
    preds, head_in = rpn(w, model, bev, bn)
    return preds, work, head_in


def pillars(w, model, coords, counts, voxels, bn=eval_bn):
    """PointPillars (PillarFeatureNetOld): each point decorated with its
    pillar-centre offset (which replaces its x, y), z, reflectance, its
    offset from the pillar's mean and the centre offset again; Linear +
    BN + ReLU, the max over the pillar's T slots (padded slots are zero
    inputs), scattered onto the BEV canvas, then the RPN."""
    t = voxels.shape[1]
    vx, vy = model["voxel_size"][:2]
    x0 = vx / 2 + model["point_cloud_range"][0]
    y0 = vy / 2 + model["point_cloud_range"][1]
    dtype = voxels.dtype
    slot = (torch.arange(t, device=voxels.device)[None, :]
            < counts[:, None]).to(dtype)[..., None]
    xyz = voxels[..., :3]
    mean = xyz.sum(1, keepdim=True) / counts.clamp(min=1).to(dtype).view(
        -1, 1, 1)
    px = coords[:, 2:3].to(dtype) * vx + x0
    py = coords[:, 1:2].to(dtype) * vy + y0
    center = torch.stack([voxels[..., 0] - px, voxels[..., 1] - py], -1)
    x = torch.cat([center, voxels[..., 2:], xyz - mean, center], -1) * slot
    name = "voxel_feature_extractor.pfn_layers.0.linear_bn_relu"
    y = x @ w[name + ".linear.weight"].t()
    y = torch.relu(bn(w, name + ".bn", y.reshape(-1, y.shape[-1]), -1,
                      rows=slot.reshape(-1) > 0))
    pooled = y.view(voxels.shape[0], t, -1).amax(1)
    _, ny, nx = model["grid_zyx"]
    canvas = pooled.new_zeros(pooled.shape[1], ny * nx)
    canvas[:, coords[:, 1].long() * nx + coords[:, 2].long()] = pooled.t()
    preds, head_in = rpn(w, model, canvas.view(1, -1, ny, nx), bn)
    return preds, [], head_in


NETWORKS = {"second": second, "pillars": pillars}
