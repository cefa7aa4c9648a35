"""Static-capacity sparse voxel grids and rulebook convolutions
(twin of the plan path of ``second_tpu/ops/sparse.py``).

A :class:`SparseGrid` holds features [B, V, C], linear ids [B, V]
(sentinel D*H*W on padding rows, sorted per row) and zyx coords
[B, V, 3] (-1 padding). The rulebooks come from the host planner
(``second_tpu_torch.models.sparse_middle.build_host_plan``): slots
[B, Vout, K] index the input rows, a miss is V (the zero dump row).
Both convolutions run the gather-GEMM of K1
(:func:`second_tpu_torch.ops.cuda_sparse_conv.gather_gemm`); inactive
output rows are zeroed afterwards, as in JAX. They are differentiable
through :class:`SparseConvFunction`, the twin of the JAX package's
``banded_sparse._banded_core`` custom VJP: the input gradient is K1 again
and the weight gradient is K2
(:func:`second_tpu_torch.ops.cuda_sparse_conv_dw.sparse_conv_dw`).

Weight layout: [K, Cin, Cout], K enumerating (dz, dy, dx) in C order.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .cuda_sparse_conv import gather_gemm
from .cuda_sparse_conv_dw import sparse_conv_dw


class SparseGrid(NamedTuple):
    """Batched static-capacity sparse voxel set (sorted by linear id)."""

    features: torch.Tensor  # [B, V, C]
    lin: torch.Tensor  # [B, V] int64 linear zyx ids, sentinel pad, sorted
    coords: torch.Tensor  # [B, V, 3] int32 zyx, -1 pad
    shape: Tuple[int, int, int]  # (D, H, W)

    @property
    def sentinel(self):
        d, h, w = self.shape
        return d * h * w

    @property
    def valid(self):
        return self.lin < self.sentinel


def linearize(coords, shape):
    _, h, w = shape
    c = coords.long()
    return c[..., 0] * (h * w) + c[..., 1] * w + c[..., 2]


def from_sorted_voxel_coords(features, coords, shape):
    """SparseGrid from coords [B, V, 3] zyx already sorted by linear id
    with -1 padding rows at the end (the host planner's contract)."""
    d, h, w = (int(v) for v in shape)
    valid = coords[..., 0] >= 0
    lin = torch.where(valid, linearize(coords, shape),
                      torch.full_like(valid, d * h * w, dtype=torch.long))
    return SparseGrid(features, lin, coords, (d, h, w))


def _kernel_offsets(kernel_size):
    """[K, 3] zyx kernel indices in weight-layout order (not centred;
    the caller applies the padding)."""
    kz, ky, kx = kernel_size
    return np.stack(
        [a.ravel() for a in np.meshgrid(
            np.arange(kz), np.arange(ky), np.arange(kx), indexing="ij")],
        axis=1)


def transpose_rulebook(slots, v_in):
    """Invert a strided-conv rulebook on the device (twin of
    ``banded_sparse.transpose_rulebook``): slots [B, Vout, K] (values
    >= v_in mark misses) -> [B, v_in, K] int32 where out[b, i, k] is the
    output row that reads input i at offset k, and Vout where none does. For a fixed k the map
    o -> slots[o, k] is injective, so one scatter inverts it; misses land
    on a dump row that is cut off."""
    b, vout, k = slots.shape
    s = slots.long()
    s = torch.where((s >= 0) & (s < v_in), s, torch.full_like(s, v_in))
    o = torch.arange(vout, dtype=torch.int32, device=slots.device)
    out = torch.full((b, v_in + 1, k), vout, dtype=torch.int32,
                     device=slots.device)
    out.scatter_(1, s, o[None, :, None].expand(b, vout, k))
    return out[:, :v_in].contiguous()


class SparseConvFunction(torch.autograd.Function):
    """out = gather_gemm(feat, slots, weight) with the backward of the
    JAX package's ``_banded_core_bwd``:

    * dfeat by K1: for a submanifold conv over the same rulebook with the
      weights flipped in k and transposed (full-cube offsets:
      slots[o, k] = i <=> slots[i, K-1-k] = o); for a strided conv over
      the transpose rulebook with the weights transposed. Skipped where
      the features need no gradient (the voxel means).
    * dW by K2.
    """

    @staticmethod
    def forward(ctx, feat, weight, slots, subm):
        ctx.save_for_backward(feat, weight, slots)
        ctx.subm = subm
        return gather_gemm(feat, slots, weight)

    @staticmethod
    def backward(ctx, dout):
        feat, weight, slots = ctx.saved_tensors
        dout = dout.contiguous()
        dfeat = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.subm:
                w_b = weight.flip(0).transpose(1, 2).contiguous()
                dfeat = gather_gemm(dout, slots, w_b)
            else:
                slots_t = transpose_rulebook(slots, feat.shape[1])
                dfeat = gather_gemm(dout, slots_t,
                                    weight.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = sparse_conv_dw(feat, slots, dout)
        return dfeat, dw, None, None


def subm_conv(grid: SparseGrid, slots, weights, bias=None):
    """Submanifold conv: the output active set is the input's.
    slots [B, V, K] int32 from the host plan; weights [K, Cin, Cout]."""
    out = SparseConvFunction.apply(grid.features, weights, slots, True)
    if bias is not None:
        out = out + bias
    out = torch.where(grid.valid[..., None], out, torch.zeros_like(out))
    return grid._replace(features=out)


def sparse_conv_apply(grid: SparseGrid, out_grid: SparseGrid, slots,
                      weights, bias=None):
    """Strided conv onto ``out_grid``'s active set with input slots
    [B, Vout, K] int32."""
    out = SparseConvFunction.apply(grid.features, weights, slots, False)
    if bias is not None:
        out = out + bias
    out = torch.where(out_grid.valid[..., None], out, torch.zeros_like(out))
    return out_grid._replace(features=out)


def to_dense(grid: SparseGrid):
    """[B, V, C] sparse -> [B, C, D, H, W] dense (zeros elsewhere)."""
    b, _, c = grid.features.shape
    d, h, w = grid.shape
    cells = d * h * w
    # padding rows land on a dump row that is cut off afterwards
    idx = torch.where(grid.valid, grid.lin, torch.full_like(grid.lin, cells))
    dense = grid.features.new_zeros((b, cells + 1, c))
    dense.scatter_(1, idx[..., None].expand(-1, -1, c), grid.features)
    return dense[:, :cells].reshape(b, d, h, w, c).permute(0, 4, 1, 2, 3)
