"""Sparse convolution by gather and matrix product, over rulebooks built
here from the active sites' coordinates.

An active set is its sorted linear ids ``lin`` over a grid ``shape``
(batch first, then z, y, x, row-major) with features [V, C]. A
submanifold conv keeps the set; a strided conv's output set is every
site whose window touches an active input. Kernels, strides and pads
are given per grid axis (1, 1 and 0 on the batch axis, so frames never
mix). Weights are [K, Cin, Cout] with K in (kz, ky, kx) row-major order,
and both convs are cross-correlations, as ``torch.nn.functional.conv3d``.
"""

import itertools

import torch


def kernel_offsets(kernel):
    """[K, ndim] kernel indices in weight order."""
    return torch.tensor(list(itertools.product(*(range(k) for k in kernel))),
                        dtype=torch.int64)


def to_lin(idx, shape):
    lin = idx[:, 0]
    for a in range(1, len(shape)):
        lin = lin * shape[a] + idx[:, a]
    return lin


def to_idx(lin, shape):
    out = []
    for a in reversed(range(len(shape))):
        out.append(lin % shape[a])
        lin = lin // shape[a]
    return torch.stack(out[::-1], 1)


def lookup(lin, query, ok):
    """Row of each query id in the sorted ``lin``; len(lin) for a miss."""
    n = lin.shape[0]
    if n == 0:
        return torch.zeros_like(query)
    pos = torch.searchsorted(lin, query).clamp(max=n - 1)
    hit = ok & (lin[pos] == query)
    return torch.where(hit, pos, torch.full_like(pos, n))


def _inside(idx, shape):
    upper = torch.tensor(shape, device=idx.device)
    return ((idx >= 0) & (idx < upper)).all(-1)


def _query(lin, shape, idx, offs):
    q = idx[:, None, :] + offs[None]
    ok = _inside(q, shape)
    flat = to_lin(q.reshape(-1, len(shape)), shape).reshape(ok.shape)
    return lookup(lin, flat, ok)


def subm_rulebook(lin, shape, kernel):
    """[V, K] input rows (V = miss) of a submanifold conv."""
    pad = torch.tensor([(k - 1) // 2 for k in kernel])
    offs = (kernel_offsets(kernel) - pad).to(lin.device)
    return _query(lin, shape, to_idx(lin, shape), offs)


def down_shape(shape, kernel, stride, pad):
    return tuple((shape[a] + 2 * pad[a] - kernel[a]) // stride[a] + 1
                 for a in range(len(shape)))


def down_rulebook(lin, shape, kernel, stride, pad):
    """(output ids sorted, output shape, [Vout, K] input rows) of a
    strided conv."""
    out_shape = down_shape(shape, kernel, stride, pad)
    dev = lin.device
    offs = kernel_offsets(kernel).to(dev)
    st = torch.tensor(stride, device=dev)
    pd = torch.tensor(pad, device=dev)
    # input i feeds output o at offset k where o * s = i + p - k
    num = to_idx(lin, shape)[:, None, :] + pd - offs[None]
    o = torch.div(num, st, rounding_mode="floor")
    ok = ((num % st) == 0).all(-1) & _inside(o, out_shape)
    out_lin = torch.unique(to_lin(o[ok], out_shape))
    rows = _query(lin, shape, to_idx(out_lin, out_shape) * st - pd, offs)
    return out_lin, out_shape, rows


def gather_conv(feats, rows, weight, block=65536):
    """out[v] = sum_k feats[rows[v, k]] @ weight[k] (a miss adds 0), in
    blocks of output rows."""
    k, cin, cout = weight.shape
    padded = torch.cat([feats, feats.new_zeros(1, cin)])
    w2 = weight.reshape(k * cin, cout)
    outs = [padded[rows[s:s + block]].reshape(-1, k * cin) @ w2
            for s in range(0, rows.shape[0], block)]
    return torch.cat(outs) if outs else feats.new_zeros(0, cout)


def pairs(rows, vin):
    """Rulebook hits: the (output, offset) pairs with an input."""
    return int((rows < vin).sum())
