"""The nuScenes multi-head network's weights, made on the device from the
seed, as ``weights.py`` makes the single-head networks': every tensor of
the port's state dict drawn by ``weights.draw``, the norms' running
statistics calibrated on one frame of the seed by the plain reference
(``reference/multihead.py``, through ``weights.calibrating_bn``), then,
for each of the two heads, its class conv made blind to the feature of
the cells no point reaches and its three 1x1 convs scaled to the
configuration's logit spreads. The class biases of both heads are set to
one value, so that the ``pre_max``-th best anchor's best class scores
``top_score``. The same tensors load into the port and feed the
reference.
"""

import math

import torch
import torch.nn.functional as F

from . import weights
from .reference import multihead


def _blind(w, name, x):
    """Make ``name``'s class conv blind to the most common feature vector
    of its input ``x`` [1, C, H, W] (the cells no point reaches), so
    those cells score the bias alone and never tie among the
    candidates."""
    feats = x[0].reshape(x.shape[1], -1)
    key = torch.linspace(1.0, 2.0, feats.shape[0], device=x.device) @ feats
    key = torch.round(key / key.abs().max().clamp(min=1e-30) * 1e6)
    vals, counts = torch.unique(key, return_counts=True)
    if int(counts.max()) <= 1:
        return
    xe = feats[:, key == vals[counts.argmax()]].mean(1)
    wc = w[name + ".conv_cls.weight"]
    flat = wc.reshape(wc.shape[0], -1)
    flat = flat - (flat @ xe)[:, None] * xe[None, :] / (xe @ xe)
    w[name + ".conv_cls.weight"] = flat.reshape(wc.shape)


@torch.no_grad()
def make(net, config, seed, points, device):
    """The weights {name: tensor on ``device``} for ``net`` (the port's
    module, read for its parameter names, shapes and transposed convs)
    from the seed, calibrated on the frame ``points``."""
    model, assumed = config["model"], config["assumed"]
    shapes = {n: tuple(t.shape) for n, t in net.state_dict().items()}
    transposed = {n + ".weight" for n, m in net.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    w = weights.draw(shapes, seed, device, transposed)
    _, net_in = multihead.host_example(model, points)
    _, inputs = multihead.run_network(model, w, net_in, device,
                                      weights.calibrating_bn)
    best = []
    nclass = len(model["classes"])
    for head in multihead.HEADS:
        x = inputs[head]
        _blind(w, head, x)
        for conv in weights.HEADS:
            name = f"{head}.{conv}.weight"
            y = F.conv2d(x, w[name])
            w[name] = w[name] * (assumed["head_std"][conv] / y.std())
        y = F.conv2d(x, w[f"{head}.conv_cls.weight"])
        best.append(y.view(-1, nclass, *y.shape[2:]).amax(1).reshape(-1))
    best = torch.cat(best)
    k = min(model["nms"]["pre_max"], best.numel())
    kth = float(torch.topk(best, k).values[-1])
    p = assumed["top_score"]
    for head in multihead.HEADS:
        w[f"{head}.conv_cls.bias"].fill_(math.log(p / (1 - p)) - kth)
    return w
