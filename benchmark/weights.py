"""The network's weights, made on the device from the seed.

Every tensor of the port's state dict is drawn in two large calls (one
normal, one uniform) on a generator seeded with the run's seed: conv,
sparse conv and linear weights normal with variance 1/fan_in, batch
norm scales in [0.5, 1.5] and shifts in [-0.5, 0.5]. The norms' running
statistics are then calibrated on one sweep of the seed by the plain
reference (each set to the statistics of its input there, so no layer's
output grows or vanishes), the class head is made blind to the
feature of cells no point reaches (so such cells tie at the bias, below
every candidate), and the three heads are scaled to the configuration's
logit spreads, the class head's bias set so that the
``pre_max``-th best anchor scores ``top_score``. The same tensors load
into the port (``load_state_dict``) and feed the reference.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .reference import nets, pipeline

HEADS = ("conv_box", "conv_cls", "conv_dir_cls")


def draw(shapes, seed, device, transposed=()):
    """{name: tensor} of the state dict's ``shapes`` from the seed.
    ``transposed`` names ConvTranspose2d weights ([Cin, Cout, k, k],
    fan-in Cout * k * k)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = [n for n, s in shapes.items()
              if n.endswith("_w") or n.endswith("weight") and len(s) >= 2]
    norms = sorted(n[:-len(".running_mean")] for n in shapes
                   if n.endswith(".running_mean"))
    unif = [f"{p}.{k}" for p in norms for k in ("weight", "bias")]
    total_n = sum(int(np.prod(shapes[n])) for n in normal)
    total_u = sum(int(np.prod(shapes[n])) for n in unif)
    zn = torch.randn(total_n, generator=gen, device=device)
    zu = torch.rand(total_u, generator=gen, device=device)
    w, o = {}, 0
    for n in normal:
        s = shapes[n]
        k = int(np.prod(s))
        if n.endswith("_w"):
            fan = s[0] * s[1]
        elif n in transposed:
            fan = s[1] * int(np.prod(s[2:]))
        else:
            fan = int(np.prod(s[1:]))
        w[n] = (zn[o:o + k] / math.sqrt(fan)).view(s)
        o += k
    o = 0
    for n in unif:
        s = shapes[n]
        k = int(np.prod(s))
        u = zu[o:o + k].view(s)
        w[n] = u + 0.5 if n.endswith("weight") else u - 0.5
        o += k
    for n, s in shapes.items():
        if n.endswith("running_mean"):
            w[n] = torch.zeros(s, device=device)
        elif n.endswith("running_var"):
            w[n] = torch.ones(s, device=device)
        elif n not in w:  # the heads' biases
            w[n] = torch.zeros(s, device=device)
    return w


def calibrating_bn(w, name, x, channel_dim, rows=None):
    """Eval-mode batch norm that first sets its running statistics to
    those of ``x`` (over ``rows`` where given)."""
    xs = x if rows is None else x[rows]
    dims = [d for d in range(xs.dim()) if d != channel_dim % xs.dim()]
    w[name + ".running_mean"] = xs.mean(dims)
    w[name + ".running_var"] = xs.var(dims, unbiased=False).clamp(min=1e-6)
    return nets.eval_bn(w, name, x, channel_dim)


@torch.no_grad()
def make(net, config, seed, points, device):
    """The weights {name: tensor on ``device``} for ``net`` (the port's
    module, read for its parameter names, shapes and transposed convs) from
    the seed, calibrated on the sweep ``points``."""
    model, assumed = config["model"], config["assumed"]
    shapes = {n: tuple(t.shape) for n, t in net.state_dict().items()}
    transposed = {n + ".weight" for n, m in net.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    w = draw(shapes, seed, device, transposed)
    ex, net_in = pipeline.host_example(model, points)
    _, _, x = pipeline.forward(model, w, net_in, device, calibrating_bn)
    mask = ex.get("anchors_mask")
    # cells that no point reaches share one feature vector; the class
    # head is made blind to it, so those cells score the bias alone and
    # never tie with each other among the candidates
    feats = x[0].reshape(x.shape[1], -1)
    key = torch.linspace(1.0, 2.0, feats.shape[0], device=device) @ feats
    key = torch.round(key / key.abs().max().clamp(min=1e-30) * 1e6)
    vals, counts = torch.unique(key, return_counts=True)
    empty = key == vals[counts.argmax()]
    if int(counts.max()) > 1:
        xe = feats[:, empty].mean(1)
        wc = w["rpn.conv_cls.weight"]
        flat = wc.reshape(wc.shape[0], -1)
        flat = flat - (flat @ xe)[:, None] * xe[None, :] / (xe @ xe)
        w["rpn.conv_cls.weight"] = flat.reshape(wc.shape)
    for head in HEADS:
        name = f"rpn.{head}"
        y = F.conv2d(x, w[name + ".weight"])
        w[name + ".weight"] = w[name + ".weight"] * (
            assumed["head_std"][head] / y.std())
    y = F.conv2d(x, w["rpn.conv_cls.weight"])
    nloc = model["anchors"]["per_loc"]
    logits = y.view(nloc, -1, *y.shape[2:]).permute(0, 2, 3, 1).reshape(-1)
    if mask is not None:
        logits = logits[torch.from_numpy(mask[0]).to(device)]
    k = min(model["nms"]["pre_max"], logits.numel())
    kth = torch.topk(logits, k).values[-1]
    p = assumed["top_score"]
    w["rpn.conv_cls.bias"].fill_(math.log(p / (1 - p)) - float(kth))
    return w
