"""The nuScenes residual network's weights, made on the device from the
seed, as ``weights.py`` makes the single-head networks': every tensor of
the port's state dict drawn by ``weights.draw``, the norms' running
statistics calibrated on the first of the frames it is given by the
plain reference (``reference/res8x.py``, through
``weights.calibrating_bn``), so that each block's residual sum stays of
the scale of its input, then the class conv made blind to the feature
of the cells no point reaches (``mhead_weights._blind``) and the head
fitted over every frame it is given, which are the frames the cell
serves:

* the head's three 1x1 convs scaled so that each output's spread over
  all the frames is the configuration's ``head_std``;
* the class conv scaled down further, where it must, so that no class
  logit of any frame passes ``max_logit`` once the bias is set: the
  random network's logits have long tails, and a float32 sigmoid past
  ~9 no longer tells two logits 1e-3 apart (past ~17 it reads 1.0);
* the class bias set so that, on the median frame, the ``pre_max``-th
  best anchor's best class scores ``top_score``.

The same tensors load into the port and feed the reference.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import weights
from .mhead_weights import _blind
from .reference import res8x


@torch.no_grad()
def make(net, config, seed, frames, device):
    """The weights {name: tensor on ``device``} for ``net`` (the port's
    module, read for its parameter names, shapes and transposed convs)
    from the seed, fitted on the list of point arrays ``frames``."""
    model, assumed = config["model"], config["assumed"]
    shapes = {n: tuple(t.shape) for n, t in net.state_dict().items()}
    transposed = {n + ".weight" for n, m in net.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    w = weights.draw(shapes, seed, device, transposed)
    net_ins = [res8x.host_example(model, p)[1] for p in frames]
    _, x, _ = res8x.run_network(model, w, net_ins[0], device,
                                weights.calibrating_bn)
    _blind(w, "rpn", x)
    nclass = len(model["classes"])
    k = model["nms"]["pre_max"]
    # per head conv: the sum, the sum of squares and the count of its
    # outputs over the frames; per frame: the pre_max-th best and the
    # largest class logit, before any scaling
    moments = {conv: [0.0, 0.0, 0] for conv in weights.HEADS}
    kth, top = [], []
    for i, net_in in enumerate(net_ins):
        if i:
            _, x, _ = res8x.run_network(model, w, net_in, device)
        for conv, m in moments.items():
            y = F.conv2d(x, w[f"rpn.{conv}.weight"]).double()
            m[0] += float(y.sum())
            m[1] += float((y * y).sum())
            m[2] += y.numel()
            if conv == "conv_cls":
                best = y.view(-1, nclass, *y.shape[2:]).amax(1).reshape(-1)
                kth.append(float(torch.topk(best, min(k, best.numel()))
                                 .values[-1]))
                top.append(float(best.max()))
    scale = {}
    for conv, (s1, s2, n) in moments.items():
        std = math.sqrt(max(s2 / n - (s1 / n) ** 2, 1e-30))
        scale[conv] = assumed["head_std"][conv] / std
    p = assumed["top_score"]
    level = math.log(p / (1 - p))
    mid = float(np.median(kth))
    # the largest logit of any frame, at the bias that puts the median
    # frame's pre_max-th best at ``level``
    reach = scale["conv_cls"] * (max(top) - mid)
    if level + reach > assumed["max_logit"]:
        scale["conv_cls"] *= (assumed["max_logit"] - level) / reach
    for conv in weights.HEADS:
        w[f"rpn.{conv}.weight"] = w[f"rpn.{conv}.weight"] * scale[conv]
    w["rpn.conv_cls.bias"].fill_(level - scale["conv_cls"] * mid)
    return w
