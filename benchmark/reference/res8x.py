"""The nuScenes residual sparse network in plain PyTorch and NumPy, from
the benchmark's weights (keyed by the port's parameter names) and the
configuration's sizes: OpenPCDet's ``VoxelResBackBone8x`` on the mean
of each voxel's points, its BEV map through second.pytorch v1.6's
``RPNV2`` with a 10-class head, the anchors, and the candidates its
detections are judged by, with their labels.

* Voxels: the first-come voxels of ``voxelize.voxelize`` at 0.1 x 0.1 x
  0.2 m: past ``max_voxels`` (60 000) the voxels whose first point
  arrives later are dropped, and past T (10) a voxel's later points.
  A voxel's feature is the mean of its points' 4 numbers.
* Middle (``model["middle_topology"]``): ``subm`` a submanifold conv,
  ``down`` a strided conv onto every site whose window touches an active
  one, ``block`` a residual block: subm conv, BN, ReLU, subm conv, BN,
  plus its input, ReLU. Every conv of a scale's blocks shares the
  scale's submanifold rulebook (``sparse.subm_rulebook``); each conv
  runs as ``sparse.gather_conv``; each conv but a block's second is
  followed by BN and ReLU. Nothing is dropped: the active sets are
  whole at every scale, as spconv keeps them.
  Departure: the published blocks' convs carry a bias ahead of their
  norm; at inference it folds into the norm's shift, so here, as in the
  port, they have none.
* BEV: the last active set scattered onto [C, D, H, W], read as
  [C * D, H, W] (channel c * D + d).
* Neck and head: ``multihead.backbone`` (RPNV2's stages and deblocks,
  the same layers as RPNNoHead's), then 1x1 convs predicting, per anchor
  type and cell, 7 box residuals, one logit per class and the direction
  logits; anchors ordered (anchor type, y, x), an anchor type being a
  (class, rotation) pair, rotations fastest.
  Departure: the published network's head is CenterHead; this one is
  the RPNV2 multi-class head of second.pytorch's all.fhd.config.
* Anchors, scores, candidates and the judge: ``multihead``'s (each
  class's anchors over its ``feature_map_size``, here all [1, 128, 128];
  the max over classes with its label, a label a tie where the two best
  class logits lie within ``label_eps``; single-set NMS over it), here
  with rotated IoU.

Eval-mode batch norms (eps 1e-3), float32; the caller turns TF32 off.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import multihead, nets, sparse
from .voxelize import voxelize

PREFIX = "middle_feature_extractor."


def host_example(model, points):
    """(the request's host arrays as the reference works them out, padded
    as a batch of one: anchors, the voxels sorted by linear id, their
    counts and coordinates; the voxels [V, T, F], counts [V], coords
    [V, 3] the network reads)."""
    cap = model["max_voxels"]
    coords, counts, vox = voxelize(points, model["point_cloud_range"],
                                   model["voxel_size"], cap,
                                   model["max_points_per_voxel"])
    v = len(coords)
    pv = np.zeros((cap,) + vox.shape[1:], np.float32)
    pv[:v] = vox
    pn = np.zeros(cap, np.int32)
    pn[:v] = counts
    pc = np.full((cap, 3), -1, np.int32)
    pc[:v] = coords
    ex = {"anchors": multihead.anchors(model)[None], "voxels": pv[None],
          "num_points": pn[None], "coordinates": pc[None]}
    return ex, (vox, counts, coords)


def plan(model, coords, device):
    """The middle's rulebooks for one frame's voxel coords [V, 3] (zyx):
    per scale {"lin" (sorted ids), "shape", "subm" [V, K] rows or None,
    "down": (out ids, out shape, [Vout, K] rows) or None}, and the
    voxels' order by linear id."""
    nz, ny, nx = model["grid_zyx"]
    shape = (1, nz + 1, ny, nx)
    idx = torch.as_tensor(coords, device=device).long()
    idx = torch.cat([torch.zeros_like(idx[:, :1]), idx], 1)
    lin = sparse.to_lin(idx, shape)
    order = torch.argsort(lin)
    lin = lin[order]
    scales, cur = [], None
    for op in model["middle_topology"]:
        if cur is None:
            cur = {"lin": lin, "shape": shape, "subm": None, "down": None}
            scales.append(cur)
        kernel = (1,) + nets._t3(op[2])
        if op[0] in ("subm", "block") and cur["subm"] is None:
            cur["subm"] = sparse.subm_rulebook(lin, shape, kernel)
        if op[0] == "down":
            cur["down"] = sparse.down_rulebook(
                lin, shape, kernel, (1,) + nets._t3(op[3]),
                (0,) + nets._t3(op[4]))
            lin, shape = cur["down"][0], cur["down"][1]
            cur = None
    if cur is None:  # the last active set, after the closing strided conv
        scales.append({"lin": lin, "shape": shape, "subm": None,
                       "down": None})
    return scales, order


def _scale_ops(model):
    """The topology's ops grouped by scale (subm and block ops, then the
    closing strided conv), with each op's index."""
    groups, cur = [], []
    for li, op in enumerate(model["middle_topology"]):
        cur.append((li, op))
        if op[0] == "down":
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)
    return groups


def work(model, scales):
    """Each sparse conv's work on these rulebooks, in the order they run:
    dicts of pairs, vin, vout, cin, cout, k (a block gives two)."""
    out, cin = [], model["num_point_features"]
    for sc, group in zip(scales, _scale_ops(model)):
        vin = sc["lin"].shape[0]
        for _, op in group:
            k = int(np.prod(nets._t3(op[2])))
            if op[0] == "down":
                rows = sc["down"][2]
                convs = [(rows, cin)]
            else:
                rows = sc["subm"]
                convs = ([(rows, cin)] if op[0] == "subm"
                         else [(rows, op[1]), (rows, op[1])])
            for r, ci in convs:
                out.append({"pairs": sparse.pairs(r, vin), "vin": vin,
                            "vout": r.shape[0], "cin": ci, "cout": op[1],
                            "k": k})
            cin = op[1]
    return out


def middle(w, model, feats, scales, bn=nets.eval_bn):
    """The residual middle over the sorted voxels' features [V, C] ->
    the BEV map [1, C*D, H, W] (channel c*D + d)."""
    for sc, group in zip(scales, _scale_ops(model)):
        for li, op in group:
            if op[0] == "subm":
                y = sparse.gather_conv(feats, sc["subm"],
                                       w[f"{PREFIX}subm{li}_w"])
                feats = torch.relu(bn(w, f"{PREFIX}bn{li}", y, -1))
            elif op[0] == "down":
                y = sparse.gather_conv(feats, sc["down"][2],
                                       w[f"{PREFIX}down{li}_w"])
                feats = torch.relu(bn(w, f"{PREFIX}bn{li}", y, -1))
            else:
                name = f"{PREFIX}block{li}."
                y = sparse.gather_conv(feats, sc["subm"],
                                       w[name + "conv1_w"])
                y = torch.relu(bn(w, name + "bn1", y, -1))
                y = sparse.gather_conv(y, sc["subm"], w[name + "conv2_w"])
                feats = torch.relu(bn(w, name + "bn2", y, -1) + feats)
    last = scales[-1]
    b, d, h, wd = last["shape"]
    c = feats.shape[1]
    dense = feats.new_zeros(c, b * d * h * wd)
    dense = dense.index_copy(1, last["lin"], feats.t())
    dense = dense.view(c, b, d, h, wd).permute(1, 0, 2, 3, 4)
    return dense.reshape(b, c * d, h, wd)


def heads(w, model, x):
    """The RPN head's 1x1 convs on its input -> {box_preds [A, 7],
    cls_preds [A, classes], dir_cls_preds [A, bins]}."""
    nloc = model["rpn"]["anchors_per_loc"]
    sizes = {"conv_box": 7, "conv_cls": len(model["classes"]),
             "conv_dir_cls": model["dir"]["bins"]}
    out = {}
    for conv, key in (("conv_box", "box_preds"), ("conv_cls", "cls_preds"),
                      ("conv_dir_cls", "dir_cls_preds")):
        y = F.conv2d(x, w[f"rpn.{conv}.weight"], w[f"rpn.{conv}.bias"])
        b, _, h, wd = y.shape
        out[key] = y.view(b, nloc, sizes[conv], h, wd).permute(
            0, 1, 3, 4, 2).reshape(-1, sizes[conv])
    return out


def forward(w, model, coords, counts, voxels, bn=nets.eval_bn):
    """The network on the voxels (coords [V, 3] zyx, counts [V], voxels
    [V, T, F], one frame) -> (preds {name: [A, size]}, the head's input
    [1, C, H, W], the rulebooks of :func:`plan`)."""
    nf = model["num_point_features"]
    feats = voxels[..., :nf].sum(1) / counts.clamp(min=1)[:, None].to(
        voxels.dtype)
    scales, order = plan(model, coords, voxels.device)
    bev = middle(w, model, feats[order], scales, bn)
    _, x = multihead.backbone(w, model, bev, bn)
    return heads(w, model, x), x, scales


def run_network(model, w, net_in, device, bn=nets.eval_bn):
    vox, counts, coords = net_in
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return forward(w, model, t(coords).long(), t(counts).long(), t(vox), bn)


def request(model, w, points, device, margin):
    """Everything the judge needs of one request, and each sparse conv's
    work."""
    ex, net_in = host_example(model, points)
    with torch.no_grad():
        preds, _, scales = run_network(model, w, net_in, device)
        anc = torch.from_numpy(ex["anchors"][0]).to(device)
        cand = multihead.candidates(model, preds, anc, margin)
    return {"ex": ex, "preds": preds, "cand": cand, "net_in": net_in,
            "work": work(model, scales)}
