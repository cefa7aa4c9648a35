"""One request through the reference: the host arrays the request should
carry, the preds, and the candidates its detections are judged by."""

import numpy as np
import torch

from . import boxes, nets
from .voxelize import pad_points, voxelize


def host_example(model, points):
    """(the request's host arrays as the reference works them out, padded
    as a batch of one; the voxels [V, T, F], counts [V], coords [V, 3]
    the network reads)."""
    cap = model["max_voxels"]
    coords, counts, vox = voxelize(points, model["point_cloud_range"],
                                   model["voxel_size"], cap,
                                   model["max_points_per_voxel"])
    anc = boxes.anchors(model)
    ex = {"anchors": anc[None]}
    mask = boxes.anchors_mask(model, anc, coords)
    if mask is not None:
        ex["anchors_mask"] = mask[None]
    if model["network"] == "pillars":
        buf, count = pad_points(points, model["point_cloud_range"],
                                model["points_capacity"])
        ex["points"] = buf[None]
        ex["points_count"] = np.array([[count]], np.int32)
    else:
        v = len(coords)
        pv = np.zeros((cap,) + vox.shape[1:], np.float32)
        pv[:v] = vox
        pn = np.zeros(cap, np.int32)
        pn[:v] = counts
        pc = np.full((cap, 3), -1, np.int32)
        pc[:v] = coords
        ex.update(voxels=pv[None], num_points=pn[None], coordinates=pc[None])
    return ex, (vox, counts, coords)


def forward(model, w, net_in, device, bn=nets.eval_bn):
    """The network on the reference's voxels -> (preds, sparse conv work,
    the heads' input)."""
    vox, counts, coords = net_in
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    preds, work, x = nets.NETWORKS[model["network"]](
        w, model, t(coords).long(), t(counts).long(), t(vox), bn)
    return {k: v[0] for k, v in preds.items()}, work, x


def request(model, w, points, device, margin):
    """Everything the judge needs of one request."""
    ex, net_in = host_example(model, points)
    with torch.no_grad():
        preds, work, _ = forward(model, w, net_in, device)
        anc = torch.from_numpy(ex["anchors"][0]).to(device)
        mask = (torch.from_numpy(ex["anchors_mask"][0]).to(device)
                if "anchors_mask" in ex else None)
        cand = boxes.candidates(model, preds, anc, mask, margin)
    return {"ex": ex, "preds": preds, "cand": cand, "work": work,
            "voxels": len(net_in[2])}
