"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the car.fhd main path's shapes. Every test here is marked
``cuda`` and skips without a CUDA device.

This file imports no JAX, so it runs on a GPU machine without it
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 1e-4 (fp32 sums of K*Cin products in another order, as
3xTF32 products on the tensor cores), and bitwise equal across two
calls; rows that miss at every offset exactly the bias or zero; K2
1e-5 of the largest magnitude (fp32 sums over every rule row in another
order), and bitwise equal across two calls; K3 1e-5 against the plain
version on the card (fp32 rounding of the same arithmetic); K4 exact (a
keep mask).
"""

import numpy as np
import pytest
import torch

from second_tpu_torch.core.rotated_iou import rotated_iou_matrix
from second_tpu_torch.ops import (
    cuda_iou,
    cuda_nms,
    cuda_sparse_conv,
    cuda_sparse_conv_dw,
)
from second_tpu_torch.ops import sparse as tsparse


def _random_boxes(rng, n, spread=10.0):
    return np.stack([rng.uniform(0, spread, n), rng.uniform(0, spread, n),
                     rng.uniform(0.5, 4, n), rng.uniform(0.5, 4, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


def _nms_inputs(rng, n):
    """A score-ordered IoU matrix of random boxes and a validity mask."""
    boxes = _random_boxes(rng, n, spread=12.0)
    iou = rotated_iou_matrix(boxes.astype(np.float64),
                             boxes.astype(np.float64)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    return iou, valid


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU covers the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k,vin,vout", [
    (4, 16, 27, 40000, 40000),    # car.fhd scale-0 first subm conv
    (16, 32, 27, 40000, 130048),  # scale-0 strided conv
    (64, 64, 27, 136576, 76544),  # scale-2 strided conv
])
def test_k1_cuda_matches_plain(cuda_device, cin, cout, k, vin, vout):
    g = torch.Generator().manual_seed(0)
    feat = torch.randn(1, vin, cin, generator=g)
    # ~40% hits, the rest misses (slot == vin), as on sparse scenes
    slots = torch.randint(0, int(vin * 2.5), (1, vout, k), generator=g)
    slots = torch.where(slots < vin, slots, vin).to(torch.int32)
    w = torch.randn(k, cin, cout, generator=g) * 0.1
    bias = torch.randn(cout, generator=g) * 0.01
    ref = cuda_sparse_conv.gather_gemm_plain(feat, slots, w, bias)
    dev = [t.to(cuda_device) for t in (feat, slots, w, bias)]
    before = cuda_sparse_conv.launches
    out = cuda_sparse_conv.gather_gemm(*dev)
    torch.cuda.synchronize()
    assert cuda_sparse_conv.launches == before + 1
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)


def _rulebook(g, b, vin, vout, k, hit_share):
    """Random slots [b, vout, k]: about ``hit_share`` hits, the rest the
    planner's miss (slot == vin)."""
    slots = torch.randint(0, int(vin / hit_share), (b, vout, k), generator=g)
    return torch.where(slots < vin, slots, vin).to(torch.int32)


# every (Cin, Cout) that K1 meets in car.fhd: the forwards of the 10
# sparse convs (4->16 first) and the input gradients (Cout -> Cin)
CAR_FHD_K1_WIDTHS = [(4, 16), (16, 16), (16, 32), (32, 16), (32, 32),
                     (32, 64), (64, 32), (64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("cin,cout", CAR_FHD_K1_WIDTHS)
def test_k1_cuda_car_fhd_widths(cuda_device, cin, cout, use_bias):
    """Each width against the plain version, with the second half of the
    rows missing at every offset (capacity padding): those rows are
    exactly the bias, or zero. Vout is no multiple of the 64-row tile,
    and two calls are bitwise equal."""
    g = torch.Generator().manual_seed(cin * 100 + cout)
    b, k, vin, vout = 2, 27, 5000, 6001
    feat = torch.randn(b, vin, cin, generator=g)
    slots = _rulebook(g, b, vin, vout, k, 0.4)
    slots[:, vout // 2:] = vin
    w = torch.randn(k, cin, cout, generator=g) * (k * cin) ** -0.5
    bias = torch.randn(cout, generator=g) if use_bias else None
    ref = cuda_sparse_conv.gather_gemm_plain(feat, slots, w, bias)
    dev = [t.to(cuda_device) if t is not None else None
           for t in (feat, slots, w, bias)]
    out = cuda_sparse_conv.gather_gemm(*dev)
    out2 = cuda_sparse_conv.gather_gemm(*dev)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    out = out.cpu()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    pad = out[:, vout // 2:]
    if use_bias:
        assert torch.equal(pad, bias.expand_as(pad))
    else:
        assert torch.equal(pad, torch.zeros_like(pad))


@pytest.mark.cuda
def test_k1_cuda_transposed_rulebook(cuda_device):
    """The strided input gradient's rulebook (``transpose_rulebook`` over
    the input capacity, hits scattered with no prefix of active rows)."""
    g = torch.Generator().manual_seed(5)
    b, k, vin, vout, cin, cout = 2, 27, 9000, 4000, 32, 64
    # a strided conv's rulebook: at each offset a third of the outputs
    # read distinct inputs, drawn from the first two thirds of the rows
    slots = torch.full((b, vout, k), vin, dtype=torch.int32)
    for bi in range(b):
        for kk in range(k):
            outs = torch.randperm(vout, generator=g)[:vout // 3]
            ins = torch.randperm(vin * 2 // 3, generator=g)[:vout // 3]
            slots[bi, outs, kk] = ins.to(torch.int32)
    slots_t = tsparse.transpose_rulebook(slots, vin)
    dout = torch.randn(b, vout, cout, generator=g)
    w_t = (torch.randn(k, cin, cout, generator=g) * 0.05).transpose(
        1, 2).contiguous()
    ref = cuda_sparse_conv.gather_gemm_plain(dout, slots_t, w_t)
    out = cuda_sparse_conv.gather_gemm(
        dout.to(cuda_device), slots_t.to(cuda_device), w_t.to(cuda_device))
    torch.cuda.synchronize()
    assert (ref.abs().sum(-1) == 0).any()  # rows no output reads
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k1_cuda_single_hit(cuda_device):
    """One tile with a single hit at a single offset, the others empty:
    that row is feat[slot] @ W[k] + bias, the rest exactly the bias."""
    g = torch.Generator().manual_seed(6)
    b, k, vin, vout, cin, cout = 1, 27, 300, 200, 16, 32
    feat = torch.randn(b, vin, cin, generator=g)
    w = torch.randn(k, cin, cout, generator=g)
    bias = torch.randn(cout, generator=g)
    slots = torch.full((b, vout, k), vin, dtype=torch.int32)
    slots[0, 70, 13] = 123
    out = cuda_sparse_conv.gather_gemm(
        *(t.to(cuda_device) for t in (feat, slots, w, bias))).cpu()
    ref = cuda_sparse_conv.gather_gemm_plain(feat, slots, w, bias)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    others = torch.ones(vout, dtype=torch.bool)
    others[70] = False
    assert torch.equal(out[0, others], bias.expand(vout - 1, cout))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(4, 16), (16, 16), (16, 32), (32, 32),
                                      (32, 64), (64, 64)])
def test_k2_cuda_car_fhd_widths(cuda_device, cin, cout):
    """K2 at every car.fhd (Cin, Cout), B * Vout no multiple of the tile,
    half the rows padding, and one offset with a single hit."""
    g = torch.Generator().manual_seed(cin * 100 + cout + 1)
    b, k, vin, vout = 3, 27, 4000, 5001
    feat = torch.randn(b, vin, cin, generator=g)
    slots = _rulebook(g, b, vin, vout, k, 0.4)
    slots[:, vout // 2:] = vin
    slots[..., 5] = vin
    slots[1, 17, 5] = 99
    dout = torch.randn(b, vout, cout, generator=g)
    dev = [t.to(cuda_device) for t in (feat, slots, dout)]
    ref = cuda_sparse_conv_dw.sparse_conv_dw_plain(*dev)
    dw = cuda_sparse_conv_dw.sparse_conv_dw(*dev)
    dw2 = cuda_sparse_conv_dw.sparse_conv_dw(*dev)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2)
    torch.testing.assert_close(dw, ref, rtol=0,
                               atol=1e-5 * ref.abs().max().item())
    torch.testing.assert_close(dw[5], ref[5], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,vin,vout", [
    (4, 16, 17000, 17000),    # car.fhd train scale-0 first subm conv
    (16, 32, 17000, 55296),   # scale-0 strided conv
    (32, 32, 55296, 55296),   # scale-1 subm conv
    (64, 64, 58112, 32640),   # scale-2 strided conv
])
def test_k2_cuda_matches_plain_and_is_deterministic(cuda_device, cin, cout,
                                                    vin, vout):
    g = torch.Generator().manual_seed(1)
    b, k = 8, 27
    feat = torch.randn(b, vin, cin, generator=g)
    slots = torch.randint(0, int(vin * 2.5), (b, vout, k), generator=g)
    slots = torch.where(slots < vin, slots, vin).to(torch.int32)
    slots[:, vout // 2:] = vin  # capacity padding rows miss everywhere
    dout = torch.randn(b, vout, cout, generator=g)
    dev = [t.to(cuda_device) for t in (feat, slots, dout)]
    ref = cuda_sparse_conv_dw.sparse_conv_dw_plain(*dev)
    before = cuda_sparse_conv_dw.launches
    dw = cuda_sparse_conv_dw.sparse_conv_dw(*dev)
    dw2 = cuda_sparse_conv_dw.sparse_conv_dw(*dev)
    torch.cuda.synchronize()
    assert cuda_sparse_conv_dw.launches == before + 2
    assert torch.equal(dw, dw2)
    torch.testing.assert_close(dw, ref, rtol=0,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
def test_k3_cuda_matches_plain(cuda_device):
    # the plain version runs on the card too: at 40 m from the origin
    # the Green's-theorem cross terms are ~1e3, so fp32 IoU moves by
    # ~1e-5 between the CPU's and the card's cos/sin alone
    rng = np.random.RandomState(3)
    boxes = torch.from_numpy(_random_boxes(rng, 1000, spread=40.0))
    boxes = boxes.to(cuda_device)
    ref = cuda_iou.rotated_iou_matrix_plain(boxes, boxes)
    before = cuda_iou.launches
    out = cuda_iou.rotated_iou_matrix(boxes, boxes)
    torch.cuda.synchronize()
    assert cuda_iou.launches == before + 1
    assert (ref > 0).float().mean() > 0.01
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_k4_cuda_matches_plain(cuda_device):
    rng = np.random.RandomState(4)
    iou, valid = _nms_inputs(rng, 1000)
    iou_t, valid_t = torch.from_numpy(iou), torch.from_numpy(valid)
    ref = cuda_nms.greedy_suppress_plain(iou_t, valid_t, 0.01)
    before = cuda_nms.launches
    keep = cuda_nms.greedy_suppress(iou_t.to(cuda_device),
                                    valid_t.to(cuda_device), 0.01)
    torch.cuda.synchronize()
    assert cuda_nms.launches == before + 1
    assert torch.equal(keep.cpu(), ref)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    feat = torch.zeros(1, 8, 4, device=cuda_device)
    slots = torch.zeros(1, 8, 27, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="slots must be"):
        cuda_sparse_conv.gather_gemm(feat, slots,
                                     torch.zeros(27, 4, 16, device=cuda_device))
    with pytest.raises(ValueError, match="power of two"):
        cuda_sparse_conv.gather_gemm(feat, slots.int(),
                                     torch.zeros(27, 4, 12, device=cuda_device))
    boxes = torch.zeros(4, 5, device=cuda_device).t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        cuda_iou.rotated_iou_matrix(boxes, boxes)
    with pytest.raises(ValueError, match="bool"):
        cuda_nms.greedy_suppress(torch.zeros(4, 4, device=cuda_device),
                                 torch.zeros(4, device=cuda_device), 0.5)
