"""The numbers that decide ``correct`` for requests that return
detections, each worked out by the reference and compared with what the
port returned.

* ``prep_mismatch``: elements of the request's host arrays (voxels,
  counts, coordinates or the padded points; anchors and their mask) that
  differ from the reference's. Exact.
* ``preds_err``: the widest gap of the network's preds, max |port - ref|
  over max |ref| of each head, the largest over heads and requests.
* ``det_err``: the widest gap between a returned detection and the
  reference candidate nearest to it: box (relative above 1 m), yaw
  (rad) and score. Where the candidate's two largest direction logits
  lie within ``dir_eps`` of each other, rounding may pick either bin,
  and its yaw is compared up to whole bin periods.
* ``nms_violations``: returned detections that break greedy NMS over the
  reference's candidates, up to ``eps`` in score and ``iou_tol`` in IoU:
  a detection that matches no candidate within ``match_tol``, two that
  match one, two kept that overlap, a kept one that is not eligible, or
  an eligible candidate left out that no kept (or possibly kept but
  out-of-range) candidate of at least its score suppresses.
"""

import numpy as np

from . import boxes as B


def prep_mismatch(port_ex, ref_ex):
    """Elements of the port's host arrays that differ from the
    reference's (same keys); a shape mismatch counts every element."""
    bad = 0
    for key, ref in ref_ex.items():
        got = np.asarray(port_ex[key])
        ref = np.asarray(ref)
        if got.shape != ref.shape:
            bad += max(got.size, ref.size)
        else:
            bad += int(np.count_nonzero(got != ref))
    return bad


def preds_err(port, ref):
    return max(float((port[k].double() - ref[k].double()).abs().max()
                     / ref[k].double().abs().max().clamp(min=1e-30))
               for k in ref)


def _gaps(det_box, det_score, cand, tie, period):
    """The gap of one detection to every candidate: the widest of its
    box's differences (each over the candidate's value where that is
    above 1: a size decodes through exp, and random weights give some
    boxes tens of metres long), its yaw's (rad, wrapped; up to whole
    ``period`` where ``tie`` says the candidate's direction bin is a tie)
    and its score's."""
    ref = cand["boxes"][:, :6]
    d = (np.abs(ref - det_box[:6]) / np.maximum(np.abs(ref), 1.0)).max(1)
    dy = det_box[6] - cand["boxes"][:, 6]
    dyaw = np.abs(np.arctan2(np.sin(dy), np.cos(dy)))
    r = np.mod(dy, period)
    dyaw = np.where(tie, np.minimum(r, period - r), dyaw)
    return np.maximum(np.maximum(d, dyaw), np.abs(cand["scores"] - det_score))


def judge(model, dets_boxes, dets_scores, cand, tol):
    """(det_err, nms_violations, the violations by kind) of one request's
    returned detections (boxes [n, 7], scores [n]) against the
    reference's candidates (:func:`boxes.candidates`)."""
    nms = model["nms"]
    eps, iou_tol = tol["eps"], tol["iou_tol"]
    thr, ithr = nms["score_threshold"], nms["iou_threshold"]
    n_top = int(cand["top"].sum())
    tie = cand["dir_margin"] <= tol["dir_eps"]
    period = 2 * np.pi / model["dir"]["bins"]
    matched, det_err = [], 0.0
    why = {"unmatched": 0, "duplicate": 0, "ineligible": 0, "overlap": 0,
           "missed": 0}
    for box, score in zip(np.asarray(dets_boxes, np.float64),
                          np.asarray(dets_scores, np.float64)):
        gaps = _gaps(box, score, cand, tie, period)
        c = int(np.argmin(gaps))
        gap = float(gaps[c])
        det_err = max(det_err, gap)
        if gap > tol["match_tol"]:
            why["unmatched"] += 1
            continue
        matched.append(c)
    kept = np.array(sorted(set(matched)), np.int64)
    why["duplicate"] += len(matched) - len(kept)
    s = cand["scores"]
    s_top = s[n_top - 1] if n_top else np.inf
    # eligible: in the top pre_max and at or above the threshold, with
    # ties at either edge let through
    for c in kept:
        if not ((c < n_top or s[c] >= s_top - eps) and s[c] >= thr - eps):
            why["ineligible"] += 1
    # who may have suppressed others: the kept, and candidates the port
    # could have kept and then dropped for their centre's range
    sup = np.zeros(len(s), bool)
    sup[kept] = True
    sup |= ~cand["in_range"]
    i, j, iou = B.overlaps(cand["bev"], nms["rotated"])
    kk = np.zeros(len(s), bool)
    kk[kept] = True
    why["overlap"] += int(np.count_nonzero(kk[i] & kk[j]
                                           & (iou > ithr + iou_tol)))
    covered = np.zeros(len(s), bool)
    near = iou > ithr - iou_tol
    for a, b in ((i[near], j[near]), (j[near], i[near])):
        # b is suppressed by a when a could be kept and scores at least
        # as high, up to eps
        ok = sup[a] & (s[a] >= s[b] - eps)
        covered[b[ok]] = True
    # truncation: a candidate with post_max kept-or-hidden ones ahead of
    # it (scoring at least as high, up to eps) may be dropped
    ahead = np.array([np.count_nonzero(sup & (s >= sc - eps)) - sup[i]
                      for i, sc in enumerate(s)])
    for c in range(n_top):
        if (kk[c] or not cand["in_range"][c] or s[c] < thr + eps
                or s[c] < s_top + eps or covered[c]
                or ahead[c] >= nms["post_max"]):
            continue
        why["missed"] += 1
    return float(det_err), sum(why.values()), why
