"""car.fhd's training step in plain PyTorch: the network in training
mode (each batch norm on the batch's statistics over its active sites or
positions), the published loss (sigmoid focal classification, smooth L1
on the box with the yaw's sine difference, softmax direction bins, each
normalised by the frame's positives), its gradients by autograd, the
global-norm clip and Adam with decoupled weight decay under the one-cycle
schedule (the bias correction takes the schedule's current b1, as the
configured optimizer does).

The step's inputs are the batch's voxels and targets as the loader made
them (their augmentation is random, drawn inside the loader); the
reference works out the anchors and every rulebook again from them.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import boxes, nets


def one_cycle(opt, step):
    """(lr, b1) of the ``step``-th update (from 0), float32 as
    configured."""
    f32 = np.float32
    total = opt["total_steps"]
    a1 = max(int(total * opt["pct_start"]), 1)
    a2 = max(total - a1, 1)
    low = opt["lr_max"] / opt["div_factor"]

    def cos(start, end, pct):
        c = f32(np.cos(np.float64(f32(np.pi) * pct))) + f32(1)
        return f32(end) + f32((start - end) / 2) * c

    s = f32(step)
    if s < a1:
        pct = np.clip(s / f32(a1), f32(0), f32(1))
        return (float(cos(low, opt["lr_max"], pct)),
                float(cos(opt["moms"][0], opt["moms"][1], pct)))
    pct = np.clip((s - f32(a1)) / f32(a2), f32(0), f32(1))
    return (float(cos(opt["lr_max"], low / 1e4, pct)),
            float(cos(opt["moms"][1], opt["moms"][0], pct)))


def flatten_batch(batch):
    """The batch's voxels [B, V, T, F], counts [B, V] and coordinates
    [B, V, 3] (-1 rows padding) -> the active rows, frame index first."""
    coords = batch["coordinates"].long()
    valid = coords[..., 0] >= 0
    b = torch.arange(coords.shape[0], device=coords.device)[:, None].expand(
        valid.shape)
    c4 = torch.cat([b[valid][:, None], coords[valid]], 1)
    return c4, batch["num_points"][valid].long(), batch["voxels"][valid]


def dense_targets(batch, num_anchors):
    """labels [B, A] and reg_targets [B, A, 7], from the dense or the
    compact form (int8 labels and the positives' rows)."""
    if "labels" in batch:
        return batch["labels"].long(), batch["reg_targets"]
    labels = batch["labels_i8"].long()
    idx = batch["pos_idx"].long()
    tgt = batch["pos_targets"]
    b = labels.shape[0]
    reg = tgt.new_zeros(b, num_anchors + 1, tgt.shape[-1])
    reg.scatter_(1, idx[..., None].expand(-1, -1, tgt.shape[-1]), tgt)
    return labels, reg[:, :num_anchors]


def loss(model, preds, labels, reg, anchors, importance=None):
    """The configured loss of preds [B, A, ...] against the targets."""
    cfg = model["loss"]
    b = labels.shape[0]
    dtype = preds["box_preds"].dtype
    if importance is None:
        importance = torch.ones_like(labels, dtype=dtype)
    pos = (labels > 0).to(dtype)
    neg = (labels == 0).to(dtype)
    norm = pos.sum(1, keepdim=True).clamp(min=1.0)
    cls_w = (neg * cfg["neg_cls_weight"] + pos * cfg["pos_cls_weight"]) / norm
    reg_w = pos / norm
    target = (labels * (labels >= 0)).clamp(min=0)
    onehot = F.one_hot(target, 2).to(dtype)[..., 1:]
    # box: sine difference of the yaw, smooth L1
    bp, rt = preds["box_preds"], reg
    f = cfg["sin_error_factor"]
    r1, r2 = bp[..., 6:7] * f, rt[..., 6:7] * f
    bp = torch.cat([bp[..., :6], torch.sin(r1) * torch.cos(r2)], -1)
    rt = torch.cat([rt[..., :6], torch.cos(r1) * torch.sin(r2)], -1)
    cw = torch.tensor(cfg["code_weights"], dtype=dtype, device=bp.device)
    d = (cw * (bp - rt)).abs()
    sig2 = cfg["smooth_l1_sigma"] ** 2
    sl1 = torch.where(d <= 1.0 / sig2, 0.5 * d * d * sig2, d - 0.5 / sig2)
    loc = (sl1 * (reg_w * importance)[..., None]).sum() / b
    # class: sigmoid focal loss
    x = preds["cls_preds"]
    ce = x.clamp(min=0) - x * onehot + torch.log1p(torch.exp(-x.abs()))
    p = torch.sigmoid(x)
    p_t = onehot * p + (1 - onehot) * (1 - p)
    a = cfg["focal_alpha"]
    alpha = onehot * a + (1 - onehot) * (1 - a)
    focal = torch.pow(1 - p_t, cfg["focal_gamma"]) * alpha * ce
    cls = (focal * (cls_w * importance)[..., None]).sum() / b
    total = loc * cfg["loc_weight"] + cls * cfg["cls_weight"]
    # direction bins of the target yaw
    bins = model["dir"]["bins"]
    rot = reg[..., 6] + anchors[..., 6] - model["dir"]["offset"]
    rot = rot - torch.floor(rot / (2 * math.pi)) * (2 * math.pi)
    dirs = torch.floor(rot / (2 * math.pi / bins)).long().clamp(0, bins - 1)
    dw = pos * importance
    dw = dw / dw.sum(-1, keepdim=True).clamp(min=1.0)
    logp = F.log_softmax(preds["dir_cls_preds"], -1)
    picked = torch.gather(logp, -1, dirs[..., None])[..., 0]
    dir_loss = -(picked * dw).sum() / b
    return total + dir_loss * cfg["dir_weight"]


def forward_loss(model, w, batch, anchors):
    c4, counts, vox = flatten_batch(batch)
    preds, _, _ = nets.second(w, model, c4, counts, vox, nets.train_bn)
    labels, reg = dense_targets(batch, anchors.shape[0])
    anc = anchors[None].expand(labels.shape[0], -1, -1)
    return loss(model, preds, labels, reg, anc, batch.get("importance"))


class Adam:
    """The configured optimizer's state over ``names`` of ``w``."""

    def __init__(self, opt, w, names):
        self.opt, self.names = opt, list(names)
        self.mu = {n: torch.zeros_like(w[n]) for n in self.names}
        self.nu = {n: torch.zeros_like(w[n]) for n in self.names}
        self.count = 0

    def step(self, w, grads):
        """Clip ``grads`` by their global norm, update ``w`` in place;
        returns the clipped gradients."""
        opt = self.opt
        lr, b1 = one_cycle(opt, self.count)
        norm = torch.sqrt(sum(torch.sum(torch.square(grads[n]))
                              for n in self.names))
        scale = torch.where(norm < opt["clip_norm"], torch.ones_like(norm),
                            opt["clip_norm"] / norm)
        grads = {n: grads[n] * scale for n in self.names}
        self.count += 1
        b2, eps, wd = opt["b2"], opt["eps"], opt["weight_decay"]
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for n in self.names:
            g, p = grads[n], w[n]
            self.mu[n] = (1 - b1) * g + b1 * self.mu[n]
            self.nu[n] = (1 - b2) * torch.square(g) + b2 * self.nu[n]
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + eps)
            w[n] = p - lr * (u + wd * p)
        return grads


def run_steps(model, opt, w0, names, batches, device):
    """The reference's steps from the weights ``w0`` over ``batches``:
    (losses, the first step's clipped gradients, the weights after the
    last step)."""
    w = {k: v.detach().clone() for k, v in w0.items()}
    anchors = torch.from_numpy(boxes.anchors(model)).to(device)
    adam = Adam(opt, w, names)
    losses, first = [], None
    for batch in batches:
        leaves = {n: w[n].detach().requires_grad_(True) for n in names}
        live = dict(w, **leaves)
        total = forward_loss(model, live, batch, anchors)
        grads = torch.autograd.grad(total, [leaves[n] for n in names])
        w = {k: v.detach() for k, v in live.items()}
        clipped = adam.step(w, dict(zip(names, grads)))
        if first is None:
            first = clipped
        losses.append(float(total.detach()))
    return losses, first, w
