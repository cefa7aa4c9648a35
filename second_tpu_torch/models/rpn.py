"""Region proposal networks (twin of ``second_tpu/models/rpn.py``), NCHW.

Per stage a strided 3x3 conv and ``layer_num`` 3x3 convs (each
Conv+BN+ReLU, or Conv+GroupNorm+ReLU), or residual blocks (ResNetRPN),
a transpose-conv "deblock" per upsampled stage, the upsampled maps
concatenated, then 1x1 cls/box/dir heads reshaped anchor-type-major to
[B, nloc, H, W, size], as in JAX.

Mixed precision follows JAX's casts (no autocast): with a
``compute_dtype`` (bf16) the backbone casts its input and each
ConvBNReLU runs its conv in that dtype (batch norm: f32 statistics, the
output in the conv's dtype; GroupNorm returns f32, flax's promotion);
the heads run in f32 on the backbone's output cast back. ResNetRPN
casts nothing: its convs run in the promoted dtype of their input and
their f32 weights, as flax's do.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import MaskedBatchNorm, promoted
from .registry import register_rpn


class ConvBNReLU(nn.Module):
    """Conv (or transpose conv) + batch norm (or GroupNorm) + ReLU; the
    conv runs in ``compute_dtype`` (a torch dtype) or, where that is
    None, in the promoted dtype of its input and weight. Without a norm
    (``use_norm=False``) the conv has a bias, as in JAX."""

    def __init__(self, cin, cout, kernel=3, stride=1, transpose=False,
                 use_groupnorm=False, num_groups=32, compute_dtype=None,
                 use_norm=True):
        super().__init__()
        self.compute_dtype = compute_dtype
        if transpose:
            self.conv = nn.ConvTranspose2d(cin, cout, kernel, stride=stride,
                                           bias=not use_norm)
        else:
            self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                                  padding=(kernel - 1) // 2,
                                  bias=not use_norm)
        if use_norm and use_groupnorm:
            # contiguous channel groups, as flax groups the last axis
            self.gn = nn.GroupNorm(num_groups, cout, eps=1e-3)
        elif use_norm:
            self.bn = MaskedBatchNorm(cout)

    def forward(self, x):
        w = self.conv.weight
        x = (promoted(x, w.dtype) if self.compute_dtype is None
             else x.to(self.compute_dtype))
        w = w.to(x.dtype)
        b = self.conv.bias
        if b is not None:
            b = b.to(x.dtype)
        if isinstance(self.conv, nn.ConvTranspose2d):
            if x.device.type == "cpu" and x.dtype == torch.bfloat16:
                # torch's CPU bf16 transposed conv (2.13) returns a wrong
                # input gradient at stride 4 (tests/test_torch_bf16.py);
                # in f32 on the bf16 values, rounded once, it computes
                # what the bf16 op does
                x = F.conv_transpose2d(
                    x.float(), w.float(), None if b is None else b.float(),
                    stride=self.conv.stride).to(x.dtype)
            else:
                x = F.conv_transpose2d(x, w, b, stride=self.conv.stride)
        else:
            x = self.conv._conv_forward(x, w, b)
        if hasattr(self, "gn"):
            return F.relu(self.gn(promoted(x, torch.float32)))
        if hasattr(self, "bn"):
            return F.relu(self.bn(x, channel_dim=1))
        return F.relu(x)


class BasicBlock(nn.Module):
    """torchvision-style residual block of ResNetRPN (rpn.py:428-466):
    two 3x3 Conv+BN, a 1x1 Conv+BN shortcut where the stride or the
    width changes, ReLU of the sum."""

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = MaskedBatchNorm(planes)
        if stride != 1 or cin != planes:
            self.downsample_conv = nn.Conv2d(cin, planes, 1, stride=stride,
                                             bias=False)
            self.downsample_bn = MaskedBatchNorm(planes)

    def forward(self, x):
        x = promoted(x, self.conv1.weight.dtype)
        out = F.relu(self.bn1(self.conv1(x), channel_dim=1))
        out = self.bn2(self.conv2(out), channel_dim=1)
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x), channel_dim=1)
        return F.relu(out + x)


def head_reshape(preds, num_anchor_per_loc, per_loc_size):
    """[B, nloc*size, H, W] head output (channel a*size + s) ->
    [B, nloc, H, W, size]."""
    b, _, h, w = preds.shape
    return preds.view(b, num_anchor_per_loc, per_loc_size, h, w).permute(
        0, 1, 3, 4, 2)


class RPNNoHeadBase(nn.Module):
    """Multi-scale conv backbone + upsample-concat.

    ``layers`` holds every ConvBNReLU in the order the JAX module
    creates them (its ``ConvBNReLU_{n}``): per stage the strided conv,
    ``layer_num`` convs, then the stage's deblock. A stride below 1
    upsamples by a strided conv of 1 / stride. ``compute_dtype``: None
    (f32) or a torch dtype, the backbone's (see the module's header).
    ``use_norm=False``: biased convs without normalisation.
    """

    def __init__(self, num_class=2, layer_nums=(3, 5, 5),
                 layer_strides=(2, 2, 2), num_filters=(128, 128, 256),
                 upsample_strides=(1, 2, 4),
                 num_upsample_filters=(256, 256, 256),
                 num_input_features=128, num_anchor_per_loc=2,
                 encode_background_as_zeros=True,
                 use_direction_classifier=True, use_groupnorm=False,
                 num_groups=32, box_code_size=7, num_direction_bins=2,
                 compute_dtype=None, use_norm=True):
        super().__init__()
        if not (len(layer_strides) == len(layer_nums) == len(num_filters)):
            raise ValueError("layer_nums, layer_strides and num_filters "
                             "must have one entry per stage")
        if len(num_upsample_filters) != len(upsample_strides):
            raise ValueError("one upsample filter count per upsample stride")
        start = len(layer_nums) - len(upsample_strides)
        scales = {upsample_strides[i]
                  / np.prod(layer_strides[:i + start + 1])
                  for i in range(len(upsample_strides))}
        if len(scales) > 1:
            raise ValueError("the upsampled stages must meet at one scale")
        self.num_class = num_class
        self.num_anchor_per_loc = num_anchor_per_loc
        self.encode_background_as_zeros = encode_background_as_zeros
        self.use_direction_classifier = use_direction_classifier
        self.box_code_size = box_code_size
        self.num_direction_bins = num_direction_bins
        self.use_groupnorm = use_groupnorm
        self.num_groups = num_groups
        self.compute_dtype = compute_dtype
        self.use_norm = use_norm
        self.layers = nn.ModuleList()
        self._stages = []  # (the stage's modules, its deblock or None)
        cin = num_input_features
        for i, layer_num in enumerate(layer_nums):
            nf = num_filters[i]
            body = self._stage(cin, nf, layer_strides[i], layer_num)
            up = None
            if i - start >= 0:
                stride = upsample_strides[i - start]
                nf_up = num_upsample_filters[i - start]
                if stride >= 1:
                    s = int(np.round(stride))
                    up = self._conv(nf, nf_up, s, s, transpose=True)
                else:
                    s = int(np.round(1 / stride))
                    up = self._conv(nf, nf_up, s, s)
            self._stages.append((body, up))
            cin = nf
        self.final_num_filters = (sum(num_upsample_filters)
                                  if len(num_upsample_filters) else cin)

    def _conv(self, cin, cout, kernel, stride, transpose=False):
        """A ConvBNReLU, appended to ``layers``."""
        self.layers.append(ConvBNReLU(
            cin, cout, kernel, stride, transpose=transpose,
            use_groupnorm=self.use_groupnorm, num_groups=self.num_groups,
            compute_dtype=self.compute_dtype, use_norm=self.use_norm))
        return self.layers[-1]

    def _stage(self, cin, nf, stride, layer_num):
        """A stage's modules in the JAX module's creation order: the
        strided 3x3 conv, then ``layer_num`` 3x3 convs."""
        return [self._conv(cin, nf, 3, stride)] + [
            self._conv(nf, nf, 3, 1) for _ in range(layer_num)]

    def backbone(self, x):
        """{"out": the upsampled maps concatenated (the last stage's
        output without deblocks), "up{i}", "stage{i}"}, as the JAX
        module returns them."""
        res, ups = {}, []
        for i, (body, up) in enumerate(self._stages):
            for module in body:
                x = module(x)
            res[f"stage{i}"] = x
            if up is not None:
                ups.append(up(x))
                res[f"up{len(ups) - 1}"] = ups[-1]
        res["out"] = torch.cat(ups, dim=1) if ups else x
        return res

    def forward(self, x):
        return self.backbone(x)


class RPNBase(RPNNoHeadBase):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        nloc = self.num_anchor_per_loc
        cls_per_loc = (self.num_class if self.encode_background_as_zeros
                       else self.num_class + 1)
        c = self.final_num_filters
        self.conv_box = nn.Conv2d(c, nloc * self.box_code_size, 1)
        self.conv_cls = nn.Conv2d(c, nloc * cls_per_loc, 1)
        if self.use_direction_classifier:
            self.conv_dir_cls = nn.Conv2d(c, nloc * self.num_direction_bins, 1)

    def forward(self, x):
        x = promoted(self.backbone(x)["out"], torch.float32)
        nloc = self.num_anchor_per_loc
        cls = self.conv_cls(x)
        ret = {
            "box_preds": head_reshape(self.conv_box(x), nloc,
                                      self.box_code_size),
            "cls_preds": head_reshape(cls, nloc, cls.shape[1] // nloc),
        }
        if self.use_direction_classifier:
            ret["dir_cls_preds"] = head_reshape(
                self.conv_dir_cls(x), nloc, self.num_direction_bins)
        return ret


@register_rpn
class RPNV2(RPNBase):
    pass


@register_rpn
class RPNNoHead(RPNNoHeadBase):
    """The backbone alone: returns the dict of ``backbone``."""


@register_rpn
class ResNetRPN(RPNBase):
    """RPNBase with residual stages: each stage is ``max(layer_num, 1)``
    BasicBlocks, the first strided (``blocks``, the JAX module's
    ``BasicBlock_{n}``); the deblocks stay ConvBNReLUs (``layers``), the
    only convs ``use_norm`` reaches, as in JAX.
    JAX's ResNetRPN casts nothing, whatever its compute dtype: every
    conv runs in f32 (its f32 weights promote a bf16 input)."""

    def __init__(self, compute_dtype=None, **kwargs):
        super().__init__(**kwargs)

    def _stage(self, cin, nf, stride, layer_num):
        # called from RPNNoHeadBase.__init__, before a subclass's own
        # __init__ body could make the list
        if "blocks" not in self._modules:
            self.blocks = nn.ModuleList()
        body = [BasicBlock(cin, nf, stride)] + [
            BasicBlock(nf, nf, 1) for _ in range(1, max(layer_num, 1))]
        self.blocks.extend(body)
        return body
