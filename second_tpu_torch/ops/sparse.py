"""Static-capacity sparse voxel grids, their rulebooks and rulebook
convolutions (twin of ``second_tpu/ops/sparse.py``).

A :class:`SparseGrid` holds features [B, V, C], linear ids [B, V]
(sentinel D*H*W on padding rows, sorted per row) and zyx coords
[B, V, 3] (-1 padding). A rulebook is slots [B, Vout, K] int32 that
index the input rows, a miss being V (the zero dump row). Rulebooks come
either from the host planner
(``second_tpu_torch.models.sparse_middle.build_host_plan``, C++) or from
the device builders here, the twins of the JAX package's plain-jnp
engine: :func:`subm_queries` and :func:`sparse_conv_queries` name the
neighbour ids, :func:`lookup_many` finds them in the sorted ids (a
batched ``searchsorted``), and :func:`downsample_active_set` builds a
strided conv's output active set by sorting its candidate ids. Every
shape is static and none of them reads a device value on the host, so
the device route captures in a CUDA graph.

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


def from_voxel_coords(features, coords, shape):
    """SparseGrid from coords [B, V, 3] zyx in any order with -1 padding
    rows: a stable sort by linear id (padding last)."""
    grid = from_sorted_voxel_coords(features, coords, shape)
    lin, order = torch.sort(grid.lin, dim=-1, stable=True)
    order = order[..., None]
    coords = torch.take_along_dim(coords, order, dim=1)
    coords = torch.where((lin < grid.sentinel)[..., None], coords,
                         torch.full_like(coords, -1))
    return grid._replace(features=torch.take_along_dim(features, order, 1),
                         lin=lin, coords=coords)


def _kernel_offsets(kernel_size):
    """[K, 3] zyx kernel indices in weight-layout order (not centred;
    the caller applies the padding)."""
    kz, ky, kx = kernel_size
    return np.stack(
        [a.ravel() for a in np.meshgrid(
            np.arange(kz), np.arange(ky), np.arange(kx), indexing="ij")],
        axis=1)


def _offsets(kernel_size, device):
    """:func:`_kernel_offsets` made on ``device`` from an arange (a copy
    of host data would be a synchronising upload)."""
    _, ky, kx = kernel_size
    idx = torch.arange(int(np.prod(kernel_size)), device=device)
    return torch.stack([torch.div(idx, ky * kx, rounding_mode="floor"),
                        torch.div(idx, kx, rounding_mode="floor") % ky,
                        idx % kx], -1)


def _lookup(lin_sorted, query_lin, query_valid, sentinel):
    """Locate query ids in each row's sorted ids.

    lin_sorted [B, V]; query_lin, query_valid [B, Q]. Returns slots
    [B, Q] int32 (V where the id is absent or the query invalid) and
    found [B, Q] bool. A batched binary search: the JAX package's dense
    index grid (one int32 per cell) would take 378 MB per batch row at
    car.fhd's grid, and both give the same slots, since the active ids
    are distinct."""
    v = lin_sorted.shape[-1]
    q = torch.where(query_valid, query_lin,
                    torch.full_like(query_lin, sentinel))
    idx = torch.searchsorted(lin_sorted.contiguous(), q.contiguous())
    idx_c = idx.clamp(max=v - 1)
    found = ((torch.gather(lin_sorted, 1, idx_c) == q) & query_valid
             & (idx < v))
    return torch.where(found, idx_c, v).int(), found


def lookup_many(lin_sorted, queries, sentinel):
    """Answer several query sets (a list of (query_lin [B, Qi],
    query_valid [B, Qi])) against one sorted id array, in one search;
    returns a list of (slots [B, Qi], found [B, Qi])."""
    sizes = [q.shape[-1] for q, _ in queries]
    slots, found = _lookup(lin_sorted, torch.cat([q for q, _ in queries], 1),
                           torch.cat([ok for _, ok in queries], 1), sentinel)
    return list(zip(slots.split(sizes, 1), found.split(sizes, 1)))


def _in_bounds(coords, shape):
    """coords [..., 3] zyx inside the (D, H, W) grid."""
    return ((coords >= 0).all(-1) & (coords[..., 0] < shape[0])
            & (coords[..., 1] < shape[1]) & (coords[..., 2] < shape[2]))


def subm_queries(grid: SparseGrid, kernel_size):
    """Neighbour ids of a submanifold conv: ([B, V*K] ids, [B, V*K]
    valid, K), the offsets centred."""
    offs = _offsets(kernel_size, grid.lin.device)
    b, v = grid.lin.shape
    k = offs.shape[0]
    coords = grid.coords.long()[:, :, None, :]
    ncoords = torch.stack([coords[..., a] + offs[:, a] - (kernel_size[a] - 1)
                           // 2 for a in range(3)], -1)  # [B, V, K, 3]
    ok = _in_bounds(ncoords, grid.shape) & grid.valid[..., None]
    nlin = linearize(ncoords, grid.shape)
    return nlin.reshape(b, v * k), ok.reshape(b, v * k), k


def build_subm_rulebook(grid: SparseGrid, kernel_size):
    """Neighbour slots [B, V, K] int32 (V = missing neighbour) and found
    [B, V, K] of a submanifold conv on this active set, shared by every
    subm conv with this kernel on it (spconv's ``indice_key``)."""
    b, v = grid.lin.shape
    nlin, ok, k = subm_queries(grid, kernel_size)
    slots, found = _lookup(grid.lin, nlin, ok, grid.sentinel)
    return slots.reshape(b, v, k), found.reshape(b, v, k)


def _down_shape(shape, kernel_size, stride, padding):
    return tuple((shape[a] + 2 * padding[a] - kernel_size[a]) // stride[a]
                 + 1 for a in range(3))


def downsample_active_set(grid: SparseGrid, kernel_size, stride, padding,
                          out_capacity=None, return_count=False):
    """Output active set of a strided sparse conv (spconv's: every output
    whose kernel window touches an active input), sorted by linear id.

    Per axis an input coord c reaches the outputs o in
    [ceil((c + p - k + 1) / s), floor((c + p) / s)], at most ceil(k/s)
    of them, so V * prod(ceil(k/s)) candidate ids are sorted; the first
    occurrence of each id takes its rank, and ranks from
    ``out_capacity`` (default V) on are dropped, the highest ids first.
    Returns a SparseGrid with zero features [B, Vout, 1]; with
    return_count also the true unique count [B] before that cut, so an
    overflow is observable.
    """
    b, v = grid.lin.shape
    dev = grid.lin.device
    out_shape = _down_shape(grid.shape, kernel_size, stride, padding)
    ncand = tuple(-(-k // s) for k, s in zip(kernel_size, stride))
    cand, ok = [], []
    for axis in range(3):
        c = grid.coords[..., axis].long()
        k, s, p = kernel_size[axis], stride[axis], padding[axis]
        hi = torch.div(c + p, s, rounding_mode="floor")
        lo = -torch.div(-(c + p - k + 1), s, rounding_mode="floor")
        cd = hi[..., None] - torch.arange(ncand[axis], device=dev)
        cand.append(cd)
        ok.append((cd >= lo[..., None]) & (cd >= 0) & (cd < out_shape[axis]))
    full = (b, v) + ncand
    ocoords = torch.stack([
        cand[0][:, :, :, None, None].expand(full),
        cand[1][:, :, None, :, None].expand(full),
        cand[2][:, :, None, None, :].expand(full)], -1).reshape(b, -1, 3)
    valid = (ok[0][:, :, :, None, None] & ok[1][:, :, None, :, None]
             & ok[2][:, :, None, None, :] & grid.valid[:, :, None, None, None])
    out_sentinel = out_shape[0] * out_shape[1] * out_shape[2]
    olin = torch.where(valid.reshape(b, -1), linearize(ocoords, out_shape),
                       out_sentinel)
    olin = torch.sort(olin, dim=-1).values
    is_new = torch.cat([olin.new_ones((b, 1), dtype=torch.bool),
                        olin[:, 1:] != olin[:, :-1]], 1)
    is_new &= olin < out_sentinel
    vout = out_capacity or v
    rank = torch.cumsum(is_new, -1) - 1
    # first occurrences within capacity go to their rank, the rest to a
    # dump column that is cut off
    rank = torch.where(is_new & (rank < vout), rank, vout)
    new_lin = olin.new_full((b, vout + 1), out_sentinel)
    new_lin.scatter_(1, rank, olin)
    new_lin = new_lin[:, :vout]
    hw = out_shape[1] * out_shape[2]
    new_coords = torch.stack([
        torch.div(new_lin, hw, rounding_mode="floor"),
        torch.div(new_lin % hw, out_shape[2], rounding_mode="floor"),
        new_lin % out_shape[2]], -1)
    new_coords = torch.where((new_lin < out_sentinel)[..., None], new_coords,
                             -1).int()
    out = SparseGrid(torch.zeros((b, vout, 1), device=dev), new_lin,
                     new_coords, out_shape)
    if return_count:
        return out, is_new.sum(-1)
    return out


def sparse_conv_queries(grid: SparseGrid, out_grid: SparseGrid, kernel_size,
                        stride, padding):
    """Input ids a strided conv reads: ([B, Vout*K] ids, [B, Vout*K]
    valid, K), input = out * stride - pad + offset."""
    b, vout = out_grid.lin.shape
    offs = _offsets(kernel_size, grid.lin.device)
    k = offs.shape[0]
    coords = out_grid.coords.long()[:, :, None, :]
    icoords = torch.stack([coords[..., a] * stride[a] - padding[a]
                           + offs[:, a] for a in range(3)], -1)
    ok = _in_bounds(icoords, grid.shape) & out_grid.valid[..., None]
    ilin = linearize(icoords, grid.shape)
    return ilin.reshape(b, vout * k), ok.reshape(b, vout * k), k


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
    slots [B, V, K] int32 (the host plan's or
    :func:`build_subm_rulebook`'s); weights [K, Cin, Cout]."""
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


def sparse_conv(grid: SparseGrid, out_grid: SparseGrid, weights,
                kernel_size, stride, padding, bias=None):
    """Strided conv onto ``out_grid``'s active set, its input slots
    looked up on the device (input = out * stride - pad + offset)."""
    b, vout = out_grid.lin.shape
    ilin, ok, k = sparse_conv_queries(grid, out_grid, kernel_size, stride,
                                      padding)
    slots, _ = _lookup(grid.lin, ilin, ok, grid.sentinel)
    return sparse_conv_apply(grid, out_grid, slots.reshape(b, vout, k),
                             weights, bias)


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
