"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the car.fhd main path's shapes. Every test here is marked
``cuda`` and skips without a CUDA device.

This file imports no JAX, so it runs on a GPU machine without it
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 1e-4 (fp32 sums of K*Cin products in another order); K2
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
