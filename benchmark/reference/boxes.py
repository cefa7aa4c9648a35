"""Anchors, box decoding, BEV IoU, greedy NMS and the detections of one
sweep, from the configuration's sizes.

Anchors are ordered (anchor type, y, x), the order of the network's
heads; an anchor type is a (size, rotation) pair, rotations fastest.
Rotated IoU is computed in float64 from the convex intersection of the
two boxes (corners of each inside the other and the edges' crossings),
for the pairs whose circumcircles meet; others are 0.
"""

import numpy as np
import torch


def anchors(model):
    """[A, 7] float32 (x, y, z, w, l, h, yaw)."""
    a = model["anchors"]
    _, ny, nx = model["grid_zyx"]
    fy, fx = ny // model["feature_stride"], nx // model["feature_stride"]
    f32 = np.float32
    if a["kind"] == "range":
        r = np.asarray(a["range"], f32)
        x = np.linspace(r[0], r[3], fx, dtype=f32)
        y = np.linspace(r[1], r[4], fy, dtype=f32)
        z = np.linspace(r[2], r[5], 1, dtype=f32)[0]
    else:
        s = np.asarray(a["strides"], f32)
        o = np.asarray(a["offsets"], f32)
        x = np.arange(fx, dtype=f32) * s[0] + o[0]
        y = np.arange(fy, dtype=f32) * s[1] + o[1]
        z = o[2]
    sizes = np.asarray(a["sizes"], f32).reshape(-1, 3)
    types = [(sz, f32(rot)) for sz in sizes for rot in a["rotations"]]
    out = np.empty((len(types), fy, fx, 7), f32)
    for t, (sz, rot) in enumerate(types):
        out[t, ..., 0] = x[None, :]
        out[t, ..., 1] = y[:, None]
        out[t, ..., 2] = z
        out[t, ..., 3:6] = sz
        out[t, ..., 6] = rot
    return out.reshape(-1, 7)


def anchors_mask(model, anchor_arr, coords):
    """Anchors whose BEV footprint (the nearest axis-aligned box) covers
    more than ``anchor_area_threshold`` occupied pillars (a summed-area
    table over the voxels' BEV cells); None where the threshold is < 0."""
    thr = model["anchor_area_threshold"]
    if thr < 0:
        return None
    _, ny, nx = model["grid_zyx"]
    vs = np.asarray(model["voxel_size"], np.float32)
    pr = np.asarray(model["point_cloud_range"], np.float32)
    dense = np.zeros((ny, nx), np.float32)
    np.add.at(dense, (coords[:, 1], coords[:, 2]), 1)
    dense = dense.cumsum(0).cumsum(1)
    bev = anchor_arr[:, [0, 1, 3, 4, 6]]
    rot = np.abs(bev[:, 4] - np.floor(bev[:, 4] / np.pi + 0.5) * np.pi)
    wl = np.where((rot > np.pi / 4)[:, None], bev[:, [3, 2]], bev[:, 2:4])
    near = np.concatenate([bev[:, :2] - wl / 2, bev[:, :2] + wl / 2], 1)
    ix = lambda v, a: np.floor((v - pr[a]) / vs[a]).astype(np.int64)
    c0 = np.clip(ix(near[:, 0], 0), 0, None)
    c1 = np.clip(ix(near[:, 1], 1), 0, None)
    c2 = np.clip(ix(near[:, 2], 0), 0, nx - 1)
    c3 = np.clip(ix(near[:, 3], 1), 0, ny - 1)
    area = dense[c3, c2] - dense[c3, c0] - dense[c1, c2] + dense[c1, c0]
    return area > thr


def decode(enc, anc):
    """Box residuals [..., 7] on anchors [..., 7] -> boxes."""
    xa, ya, za, wa, la, ha, ra = anc.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = enc.unbind(-1)
    diag = torch.sqrt(wa ** 2 + la ** 2)
    return torch.stack([xt * diag + xa, yt * diag + ya, zt * ha + za,
                        torch.exp(wt) * wa, torch.exp(lt) * la,
                        torch.exp(ht) * ha, rt + ra], -1)


def corners(b):
    """[N, 5] (x, y, w, l, yaw) float64 -> [N, 4, 2] corners."""
    x, y, w, l, r = b.T
    dx = np.stack([-w, -w, w, w], 1) * 0.5
    dy = np.stack([-l, l, l, -l], 1) * 0.5
    c, s = np.cos(r)[:, None], np.sin(r)[:, None]
    return np.stack([dx * c + dy * s + x[:, None],
                     -dx * s + dy * c + y[:, None]], -1)


def _inside(pts, b, tol=1e-9):
    """pts [P, M, 2] inside box b [P, 5] -> [P, M]."""
    px = pts[..., 0] - b[:, None, 0]
    py = pts[..., 1] - b[:, None, 1]
    c, s = np.cos(b[:, None, 4]), np.sin(b[:, None, 4])
    dx = c * px - s * py
    dy = s * px + c * py
    return ((np.abs(dx) <= b[:, None, 2] / 2 + tol)
            & (np.abs(dy) <= b[:, None, 3] / 2 + tol))


def rotated_iou_pairs(a, b):
    """IoU of box a[i] with b[i], [P, 5] float64 each -> [P]."""
    if len(a) == 0:
        return np.zeros(0)
    ca, cb = corners(a), corners(b)
    pts = [cb, ca]
    ok = [_inside(cb, a), _inside(ca, b)]
    # every edge of a against every edge of b
    p = ca[:, :, None, :]
    r = np.roll(ca, -1, 1)[:, :, None, :] - p
    q = cb[:, None, :, :]
    s = np.roll(cb, -1, 1)[:, None, :, :] - q
    cross = lambda u, v: u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]
    den = cross(r, s)
    safe = np.where(den == 0, 1.0, den)
    t = cross(q - p, s) / safe
    u = cross(q - p, r) / safe
    hit = (den != 0) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts.append((p + t[..., None] * r).reshape(len(a), 16, 2))
    ok.append(hit.reshape(len(a), 16))
    pts = np.concatenate(pts, 1)
    ok = np.concatenate(ok, 1)
    n = ok.sum(1)
    cen = (pts * ok[..., None]).sum(1) / np.maximum(n, 1)[:, None]
    ang = np.arctan2(pts[..., 1] - cen[:, None, 1],
                     pts[..., 0] - cen[:, None, 0])
    ang = np.where(ok, ang, np.inf)
    order = np.argsort(ang, 1)
    sp = np.take_along_axis(pts, order[..., None], 1)
    idx = np.arange(pts.shape[1])[None, :]
    nxt = np.where(idx + 1 < n[:, None], idx + 1, 0)
    sq = np.take_along_axis(sp, nxt[..., None], 1)
    term = np.where(idx < n[:, None], cross(sp, sq), 0.0)
    inter = np.where(n >= 3, np.abs(term.sum(1)) / 2, 0.0)
    union = a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def standup(b):
    """[N, 5] -> [N, 4] xyxy of the corners' extent."""
    c = corners(b)
    return np.concatenate([c.min(1), c.max(1)], 1)


def standup_iou_pairs(a, b):
    sa, sb = standup(a), standup(b)
    iw = np.minimum(sa[:, 2], sb[:, 2]) - np.maximum(sa[:, 0], sb[:, 0])
    ih = np.minimum(sa[:, 3], sb[:, 3]) - np.maximum(sa[:, 1], sb[:, 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area = lambda s: (s[:, 2] - s[:, 0]) * (s[:, 3] - s[:, 1])
    union = area(sa) + area(sb) - inter
    return inter / np.where(union <= 0, 1.0, union)


def overlaps(bev, rotated):
    """The pairs (i, j), i < j, of [N, 5] boxes that may overlap (their
    circumcircles meet) and their IoU: (i [P], j [P], iou [P])."""
    bev = np.asarray(bev, np.float64)
    rad = np.hypot(bev[:, 2], bev[:, 3]) / 2
    d = np.hypot(bev[:, None, 0] - bev[None, :, 0],
                 bev[:, None, 1] - bev[None, :, 1])
    i, j = np.nonzero(np.triu(d <= (rad[:, None] + rad[None, :]) * 1.001, 1))
    fn = rotated_iou_pairs if rotated else standup_iou_pairs
    return i, j, fn(bev[i], bev[j])


def greedy_nms(n, valid, pairs, thr):
    """Keep mask of candidates 0..n-1 (in score order) under greedy NMS:
    a valid candidate is kept unless an earlier kept one overlaps it by
    more than ``thr``."""
    i, j, iou = pairs
    nbrs = [[] for _ in range(n)]
    for a, b in zip(i[iou > thr], j[iou > thr]):
        nbrs[a].append(b)
    keep = np.zeros(n, bool)
    dead = ~np.asarray(valid, bool)
    for a in range(n):
        if dead[a]:
            continue
        keep[a] = True
        for b in nbrs[a]:
            dead[b] = True
    return keep


def limit_period(v, offset, period):
    return v - torch.floor(v / period + offset) * period


def candidates(model, preds, anc, mask, extra):
    """The top ``nms.pre_max + extra`` anchors by score (masked anchors
    excluded; ties to the lower index): their decoded boxes [n, 7] with
    the direction bin applied to the yaw, BEV boxes [n, 5] as NMS sees
    them, scores [n], their rank, and the gap between the two largest
    direction logits of each."""
    nms = model["nms"]
    scores = torch.sigmoid(preds["cls_preds"][:, 0])
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1.0))
    top_s, top_i = torch.sort(scores, descending=True, stable=True)
    k = min(nms["pre_max"] + extra, scores.shape[0])
    top_s, top_i = top_s[:k], top_i[:k]
    if mask is not None:
        keep = top_s >= 0
        top_s, top_i = top_s[keep], top_i[keep]
    boxes = decode(preds["box_preds"][top_i], anc[top_i])
    bev = boxes[:, [0, 1, 3, 4, 6]]
    d = model["dir"]
    period = 2 * np.pi / d["bins"]
    dir_logits = preds["dir_cls_preds"][top_i]
    dirs = torch.argmax(dir_logits, -1).to(boxes.dtype)
    top2 = torch.topk(dir_logits, 2, -1).values
    yaw = (limit_period(boxes[:, 6] - d["offset"], d["limit_offset"], period)
           + d["offset"] + period * dirs)
    out = torch.cat([boxes[:, :6], yaw[:, None]], 1)
    lo, hi = model["post_center_range"][:3], model["post_center_range"][3:]
    in_range = torch.ones_like(top_s, dtype=torch.bool)
    for a in range(3):
        in_range &= (out[:, a] >= lo[a]) & (out[:, a] <= hi[a])
    to_np = lambda t: t.detach().double().cpu().numpy()
    return {"boxes": to_np(out), "bev": to_np(bev), "scores": to_np(top_s),
            "in_range": in_range.cpu().numpy(),
            "dir_margin": to_np(top2[:, 0] - top2[:, 1]),
            "top": np.arange(len(top_s)) < nms["pre_max"]}


def detections(model, cand):
    """Greedy NMS over the top ``pre_max`` candidates at or above the
    score threshold, the first ``post_max`` kept, those in the post
    centre range: (boxes [n, 7], scores [n])."""
    nms = model["nms"]
    n = int(cand["top"].sum())
    pairs = overlaps(cand["bev"][:n], nms["rotated"])
    valid = cand["scores"][:n] >= nms["score_threshold"]
    keep = np.flatnonzero(greedy_nms(n, valid, pairs,
                                     nms["iou_threshold"]))[:nms["post_max"]]
    keep = keep[cand["in_range"][keep]]
    return cand["boxes"][keep], cand["scores"][keep]
