"""The nuScenes multi-head PointPillars in plain PyTorch and NumPy, from
the benchmark's weights (keyed by the port's parameter names) and the
configuration's sizes: second.pytorch v1.6's ``VoxelNetNuscenesMultiHead``
(``net_multi_head.py``) on ``PillarFeatureNetRadius``,
``PointPillarsScatter`` and ``RPNNoHead``, its anchors, and the
candidates its detections are judged by, with their labels.

* Encoder: each point of a pillar decorated as (its xy radius, z, time
  lag, its offset from the pillar's mean, its offset from the pillar's
  centre), padded slots zero; Linear (no bias) + BN + ReLU, the max over
  the pillar's T slots (a padded slot joins it with relu(BN(0))).
  Pillars are the first-come voxels of ``voxelize.voxelize``: past
  ``max_voxels`` (30 000, the eval reader's) the pillars whose first
  point arrives later are dropped, and past T (20) a pillar's later
  points, as upstream's voxelizer drops them.
* Backbone: per stage a strided 3x3 conv and ``layer_nums`` 3x3 convs
  (each conv + BN + ReLU, padding 1), then the stage's deblock to the
  common scale: a transposed conv of kernel and stride ``u`` where the
  upsample stride ``u`` >= 1, else a conv of kernel and stride 1 / u.
  Departure: that strided conv is padded by (k - 1) // 2 a side (1 for
  stage0's k = 4), as the port and the JAX package pad it; upstream's
  ``Conv2d(c, c', k, stride=k)`` is read as padding 0. Both give a
  100 x 100 map; the windows differ by one input row and column.
* Heads: the small head (three 3x3 conv + BN + ReLU at 64 channels,
  then 1x1 convs) on stage0 cropped by round(0.1 H) a side, the large
  head (1x1 convs) on the deblocks' concatenation. Each predicts, per
  anchor type and cell, 7 box residuals, one logit per class (10) and
  the direction logits; anchors are ordered (anchor type, y, x) within
  a head, the large head's first.
* Anchors: each class in the configuration's order over its
  ``feature_map_size`` (centres linspaced over its range, float32),
  rotations fastest within a class, then y, then x.
* Scores: the sigmoid of the class logits, the max over classes with
  its label (single-set NMS over it, as the configuration's
  ``use_multi_class_nms: false`` asks).

Eval-mode batch norms (eps 1e-3), float32; the caller turns TF32 off.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import boxes as B
from . import judge as J
from . import nets
from .voxelize import pad_points, voxelize

HEADS = ("large_head", "small_head")


def anchors(model):
    """[A, 7] float32 (x, y, z, w, l, h, yaw), every class's in order."""
    f32 = np.float32
    out = []
    for c in model["classes"]:
        r = np.asarray(c["range"], f32)
        nz, ny, nx = c["feature_map_size"]
        x = np.linspace(r[0], r[3], nx, dtype=f32)
        y = np.linspace(r[1], r[4], ny, dtype=f32)
        z = np.linspace(r[2], r[5], nz, dtype=f32)[0]
        rots = np.asarray(c["rotations"], f32)
        a = np.empty((len(rots), ny, nx, 7), f32)
        a[..., 0] = x[None, None, :]
        a[..., 1] = y[None, :, None]
        a[..., 2] = z
        a[..., 3:6] = np.asarray(c["sizes"], f32)
        a[..., 6] = rots[:, None, None]
        out.append(a.reshape(-1, 7))
    return np.concatenate(out)


def host_example(model, points):
    """(the request's host arrays as the reference works them out, as a
    batch of one: anchors, the in-range points padded to
    ``points_capacity`` rows and their count; the pillars [V, T, F],
    counts [V], coords [V, 3] the network reads)."""
    coords, counts, vox = voxelize(points, model["point_cloud_range"],
                                   model["voxel_size"], model["max_voxels"],
                                   model["max_points_per_voxel"])
    buf, count = pad_points(points, model["point_cloud_range"],
                            model["points_capacity"])
    ex = {"anchors": anchors(model)[None], "points": buf[None],
          "points_count": np.array([[count]], np.int32)}
    return ex, (vox, counts, coords)


def encode(w, model, coords, counts, voxels, bn):
    """PillarFeatureNetRadius and the scatter -> the BEV canvas
    [1, C, ny, nx]."""
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
    radius = torch.linalg.norm(voxels[..., :2], dim=-1, keepdim=True)
    x = torch.cat([radius, voxels[..., 2:], xyz - mean, center], -1) * slot
    name = "voxel_feature_extractor.pfn_layers.0.linear_bn_relu"
    y = x @ w[name + ".linear.weight"].t()
    y = torch.relu(bn(w, name + ".bn", y.reshape(-1, y.shape[-1]), -1,
                      rows=slot.reshape(-1) > 0))
    pooled = y.view(voxels.shape[0], t, -1).amax(1)
    _, ny, nx = model["grid_zyx"]
    canvas = pooled.new_zeros(pooled.shape[1], ny * nx)
    canvas[:, coords[:, 1].long() * nx + coords[:, 2].long()] = pooled.t()
    return canvas.view(1, -1, ny, nx)


def _cbr(w, name, x, kernel, stride, bn, transpose=False):
    weight = w[name + ".conv.weight"]
    if transpose:
        y = F.conv_transpose2d(x, weight, stride=stride)
    else:
        y = F.conv2d(x, weight, stride=stride, padding=(kernel - 1) // 2)
    return torch.relu(bn(w, name + ".bn", y, 1))


def backbone(w, model, x, bn):
    """RPNNoHead -> (stage0's map, the deblocks concatenated)."""
    r = model["rpn"]
    li, ups, stage0 = 0, [], None
    for i, n in enumerate(r["layer_nums"]):
        x = _cbr(w, f"rpn.layers.{li}", x, 3, r["layer_strides"][i], bn)
        li += 1
        for _ in range(n):
            x = _cbr(w, f"rpn.layers.{li}", x, 3, 1, bn)
            li += 1
        if i == 0:
            stage0 = x
        u = r["upsample_strides"][i]
        if u >= 1:
            s = int(round(u))
            ups.append(_cbr(w, f"rpn.layers.{li}", x, s, s, bn,
                            transpose=True))
        else:
            s = int(round(1 / u))
            ups.append(_cbr(w, f"rpn.layers.{li}", x, s, s, bn))
        li += 1
    return stage0, torch.cat(ups, 1)


def head_input(w, model, name, x, bn):
    """The input of a head's 1x1 convs: its 3x3 stack (the small head)
    on its map."""
    for j in range(model["heads"][name]["conv_stack"]):
        x = _cbr(w, f"{name}.layers.{j}", x, 3, 1, bn)
    return x


def head_preds(w, model, name, x):
    """A head's 1x1 convs on its input -> {box_preds [1, A, 7],
    cls_preds [1, A, classes], dir_cls_preds [1, A, bins]}."""
    nloc = model["heads"][name]["anchors_per_loc"]
    sizes = {"conv_box": 7, "conv_cls": len(model["classes"]),
             "conv_dir_cls": model["dir"]["bins"]}
    out = {}
    for conv, key in (("conv_box", "box_preds"), ("conv_cls", "cls_preds"),
                      ("conv_dir_cls", "dir_cls_preds")):
        y = F.conv2d(x, w[f"{name}.{conv}.weight"], w[f"{name}.{conv}.bias"])
        b, _, h, wd = y.shape
        out[key] = y.view(b, nloc, sizes[conv], h, wd).permute(
            0, 1, 3, 4, 2).reshape(b, -1, sizes[conv])
    return out


def forward(w, model, coords, counts, voxels, bn=nets.eval_bn):
    """The network on the pillars -> (preds {name: [A, size]}, large then
    small, {head: the input of its 1x1 convs})."""
    canvas = encode(w, model, coords, counts, voxels, bn)
    stage0, out = backbone(w, model, canvas, bn)
    crop = int(np.round(stage0.shape[2] * model["heads"]["small_head"][
        "crop"]))
    maps = {"large_head": out,
            "small_head": stage0[:, :, crop:-crop, crop:-crop]}
    inputs = {h: head_input(w, model, h, maps[h], bn) for h in HEADS}
    per_head = [head_preds(w, model, h, inputs[h]) for h in HEADS]
    preds = {k: torch.cat([p[k] for p in per_head], 1)[0]
             for k in per_head[0]}
    return preds, inputs


def run_network(model, w, net_in, device, bn=nets.eval_bn):
    vox, counts, coords = net_in
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return forward(w, model, t(coords).long(), t(counts).long(), t(vox), bn)


def candidates(model, preds, anc, extra):
    """The top ``nms.pre_max + extra`` anchors by their best class's
    score (ties to the lower index), as ``boxes.candidates`` gives them,
    with each one's label and the gap between its two largest class
    logits."""
    nms = model["nms"]
    logits = preds["cls_preds"]
    best, label = torch.max(logits, -1)
    scores = torch.sigmoid(best)
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    k = min(nms["pre_max"] + extra, scores.shape[0])
    top_s, top_i = top_s[:k], top_i[:k]
    boxes = B.decode(preds["box_preds"][top_i], anc[top_i])
    bev = boxes[:, [0, 1, 3, 4, 6]]
    d = model["dir"]
    period = 2 * np.pi / d["bins"]
    dir_logits = preds["dir_cls_preds"][top_i]
    dirs = torch.argmax(dir_logits, -1).to(boxes.dtype)
    top2 = torch.topk(dir_logits, 2, -1).values
    yaw = (B.limit_period(boxes[:, 6] - d["offset"], d["limit_offset"],
                          period) + d["offset"] + period * dirs)
    out = torch.cat([boxes[:, :6], yaw[:, None]], 1)
    lo, hi = model["post_center_range"][:3], model["post_center_range"][3:]
    in_range = torch.ones_like(top_s, dtype=torch.bool)
    for a in range(3):
        in_range &= (out[:, a] >= lo[a]) & (out[:, a] <= hi[a])
    cls2 = torch.topk(logits[top_i], 2, -1).values
    to_np = lambda t: t.detach().double().cpu().numpy()
    return {"boxes": to_np(out), "bev": to_np(bev), "scores": to_np(top_s),
            "in_range": in_range.cpu().numpy(),
            "dir_margin": to_np(top2[:, 0] - top2[:, 1]),
            "labels": label[top_i].cpu().numpy(),
            "cls_margin": to_np(cls2[:, 0] - cls2[:, 1]),
            "top": np.arange(len(top_s)) < nms["pre_max"]}


def request(model, w, points, device, margin):
    """Everything the judge needs of one request."""
    ex, net_in = host_example(model, points)
    with torch.no_grad():
        preds, _ = run_network(model, w, net_in, device)
        anc = torch.from_numpy(ex["anchors"][0]).to(device)
        cand = candidates(model, preds, anc, margin)
    return {"ex": ex, "preds": preds, "cand": cand, "net_in": net_in}


def detections(model, cand):
    """``boxes.detections`` with the labels: greedy NMS over the top
    ``pre_max`` candidates -> (boxes [n, 7], scores [n], labels [n])."""
    nms = model["nms"]
    n = int(cand["top"].sum())
    pairs = B.overlaps(cand["bev"][:n], nms["rotated"])
    valid = cand["scores"][:n] >= nms["score_threshold"]
    keep = np.flatnonzero(B.greedy_nms(n, valid, pairs,
                                       nms["iou_threshold"]))
    keep = keep[:nms["post_max"]]
    keep = keep[cand["in_range"][keep]]
    return cand["boxes"][keep], cand["scores"][keep], cand["labels"][keep]


def judge(model, dets_boxes, dets_scores, dets_labels, cand, tol):
    """``judge.judge`` of one request's detections, and a label check:
    a detection matched to a candidate (within ``match_tol``) whose
    label differs from the candidate's counts as an NMS violation,
    unless the candidate's two largest class logits lie within
    ``label_eps`` of each other (rounding may pick either class).
    -> (det_err, nms_violations, the violations by kind)."""
    det_err, bad, why = J.judge(model, dets_boxes, dets_scores, cand, tol)
    tie = cand["dir_margin"] <= tol["dir_eps"]
    period = 2 * np.pi / model["dir"]["bins"]
    why["label"] = 0
    for box, score, label in zip(np.asarray(dets_boxes, np.float64),
                                 np.asarray(dets_scores, np.float64),
                                 np.asarray(dets_labels)):
        gaps = J._gaps(box, score, cand, tie, period)
        c = int(np.argmin(gaps))
        if (gaps[c] <= tol["match_tol"] and label != cand["labels"][c]
                and cand["cls_margin"][c] > tol["label_eps"]):
            why["label"] += 1
    return det_err, bad + why["label"], why
