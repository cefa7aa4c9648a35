"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the car.fhd main path's shapes, and the PointPillars flat
pillar path on the card against the CPU at xyres_16's. Every test here
is marked ``cuda`` and skips without a CUDA device.

This file imports no JAX, so it runs on a GPU machine without it
(``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 1e-4 (fp32 sums of K*Cin products in another order, as
3xTF32 products on the tensor cores), and bitwise equal across two
calls; rows that miss at every offset exactly the bias or zero; K1-bf16
one bf16 ulp (2^-7 of the plain value) plus 1e-5 of the largest
magnitude (f32 sums in another order, rounded once), bitwise equal
across two calls, missing rows exactly zero; K2
1e-5 of the largest magnitude (fp32 sums over every rule row in another
order), and bitwise equal across two calls; K3 1e-5 against the plain
version on the card (fp32 rounding of the same arithmetic), exactly 0.0
where the far-pair reject applies, and bitwise equal across two calls;
K4 exact (a keep mask). The pillarizer and the voxelizer: exact
(integer outputs, the sorted points); the flat PFN canvas 1e-5 (the
per-pillar sums add with atomics on the card).
"""

import numpy as np
import pytest
import torch

from second_tpu_torch.ops import (
    cuda_iou,
    cuda_nms,
    cuda_sparse_conv,
    cuda_sparse_conv_bf16,
    cuda_sparse_conv_dw,
)
from second_tpu_torch.data import make_kitti_scene
from second_tpu_torch.models import pp_fast
from second_tpu_torch.models.registry import get_vfe_class
from second_tpu_torch.ops import sparse as tsparse
from second_tpu_torch.ops import voxelize as tvox

# xyres_16's pillar geometry: a [432, 496, 1] grid, T = 100
PP_VOXEL = (0.16, 0.16, 4.0)
PP_RANGE = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
PP_GRID = (432, 496, 1)
PP_T = 100


def _random_boxes(rng, n, spread=10.0):
    return np.stack([rng.uniform(0, spread, n), rng.uniform(0, spread, n),
                     rng.uniform(0.5, 4, n), rng.uniform(0.5, 4, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


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
# sparse convs (4->16 first) and the input gradients (Cout -> Cin), k 27
CAR_FHD_K1_WIDTHS = [(4, 16), (16, 16), (16, 32), (32, 16), (32, 32),
                     (32, 64), (64, 32), (64, 64)]
# K1's 128-wide instantiations, whose columns two blocks split, as the
# residual nuScenes middle meets them: conv4's strided 64 -> 128 (k 27),
# its blocks' 128 -> 128 subm convs (k 27) and conv_out's (3, 1, 1)
# 128 -> 128 (k 3); Cin 48 and 96 pad to 64 and 128 with zeros
WIDE_K1_CASES = [(64, 128, 27), (64, 128, 3), (128, 128, 27),
                 (128, 128, 3), (48, 128, 27), (96, 128, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize(
    "cin,cout,k", [(ci, co, 27) for ci, co in CAR_FHD_K1_WIDTHS]
    + WIDE_K1_CASES)
def test_k1_cuda_car_fhd_widths(cuda_device, cin, cout, k, use_bias):
    """Each width against the plain version, with the second half of the
    rows missing at every offset (capacity padding): those rows are
    exactly the bias, or zero. Vout is no multiple of the 64-row tile,
    each call is one launch, and two calls are bitwise equal."""
    g = torch.Generator().manual_seed(cin * 100 + cout + 10000 * (k != 27))
    b, vin, vout = 2, 5000, 6001
    feat = torch.randn(b, vin, cin, generator=g)
    slots = _rulebook(g, b, vin, vout, k, 0.4)
    slots[:, vout // 2:] = vin
    w = torch.randn(k, cin, cout, generator=g) * (k * cin) ** -0.5
    bias = torch.randn(cout, generator=g) if use_bias else None
    ref = cuda_sparse_conv.gather_gemm_plain(feat, slots, w, bias)
    dev = [t.to(cuda_device) if t is not None else None
           for t in (feat, slots, w, bias)]
    before = cuda_sparse_conv.launches
    out = cuda_sparse_conv.gather_gemm(*dev)
    out2 = cuda_sparse_conv.gather_gemm(*dev)
    torch.cuda.synchronize()
    assert cuda_sparse_conv.launches == before + 2
    assert torch.equal(out, out2)
    out = out.cpu()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    pad = out[:, vout // 2:]
    if use_bias:
        assert torch.equal(pad, bias.expand_as(pad))
    else:
        assert torch.equal(pad, torch.zeros_like(pad))


@pytest.mark.cuda
def test_k1_cuda_wide_refuses_other_widths(cuda_device):
    """Cout 128 only from Cin in (32, 128]; no Cout between 64 and 128."""
    for cin, cout in ((16, 128), (128, 64), (64, 96), (160, 128)):
        feat = torch.zeros(1, 8, cin, device=cuda_device)
        slots = torch.zeros(1, 8, 27, dtype=torch.int32, device=cuda_device)
        w = torch.zeros(27, cin, cout, device=cuda_device)
        with pytest.raises(ValueError, match="Cout 128"):
            cuda_sparse_conv.gather_gemm(feat, slots, w)


def _bf16_slots(g, pattern, b, vin, k):
    """(slots [b, vout, k], vout) of one K1-bf16 card case; a miss is
    written as ``vin`` unless the pattern says otherwise.

    * ``half``: ~40% hits, the second half of the rows missing at every
      offset (capacity padding), Vout off the 64-row tile;
    * ``tail``: ~40% hits in every tile but the first (all misses), and
      a last tile of 37 rows;
    * ``tiles``: tiles where every row misses beside tiles where every
      slot hits, the last tile partial;
    * ``single``: row o hits at offset (7 o) % k alone;
    * ``minus1``: ~40% hits, misses written as -1, as ``vin`` and as
      ``vin + 3``, rows 1000-1199 missing at every offset as -1 and rows
      2000-2099 as ``vin + 3``;
    * ``batches``: batch 0 ~90% hits in its first half, batch 1 ~10%
      hits everywhere but in tiles 3-5.
    """
    if pattern == "half":
        vout = 6001
        slots = _rulebook(g, b, vin, vout, k, 0.4)
        slots[:, vout // 2:] = vin
    elif pattern == "tail":
        vout = 64 * 40 + 37
        slots = _rulebook(g, b, vin, vout, k, 0.4)
        slots[:, :64] = vin
    elif pattern == "tiles":
        vout = 64 * 9 + 20
        slots = torch.randint(0, vin, (b, vout, k), generator=g,
                              dtype=torch.int32)
        for t in range(0, vout, 128):
            slots[:, t:t + 64] = vin
    elif pattern == "single":
        vout = 64 * 20 + 5
        slots = torch.full((b, vout, k), vin, dtype=torch.int32)
        o = torch.arange(vout)
        slots[:, o, (7 * o) % k] = torch.randint(
            0, vin, (b, vout), generator=g, dtype=torch.int32)
    elif pattern == "minus1":
        vout = 3001
        slots = _rulebook(g, b, vin, vout, k, 0.4)
        miss = slots == vin
        pick = torch.randint(0, 3, slots.shape, generator=g)
        slots[miss & (pick == 0)] = -1
        slots[miss & (pick == 2)] = vin + 3
        slots[:, 1000:1200] = -1
        slots[:, 2000:2100] = vin + 3
    elif pattern == "batches":
        vout = 4000
        slots = torch.cat([_rulebook(g, 1, vin, vout, k, 0.9),
                           _rulebook(g, 1, vin, vout, k, 0.1)])
        slots[0, vout // 2:] = vin
        slots[1, 3 * 64:6 * 64] = vin
    else:
        raise ValueError(pattern)
    return slots, vout


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k,offset,pattern", [
    (4, 16, 27, 0, "half"), (16, 16, 27, 0, "half"),
    (16, 32, 27, 0, "half"), (32, 32, 27, 0, "half"),
    (32, 64, 27, 0, "half"), (64, 64, 27, 0, "half"),  # car.fhd's forwards
    (64, 64, 3, 0, "half"),            # the dense tail's (3, 1, 1) kernel
    (3, 8, 27, 0, "half"), (6, 4, 27, 0, "half"),  # 2- and 4-byte copies
    (4, 16, 27, 1, "half"),            # features 2 bytes off alignment
    (64, 64, 64, 0, "half"),           # K at its limit
    (64, 64, 27, 0, "tail"), (16, 32, 27, 0, "tail"),  # a partial last tile
    (64, 64, 27, 0, "tiles"), (4, 16, 27, 0, "tiles"),  # empty beside full
    (16, 32, 1, 0, "half"), (64, 64, 1, 0, "tiles"),   # K = 1
    (32, 32, 27, 0, "single"), (64, 16, 27, 0, "single"),  # one hit a row
    (64, 64, 27, 0, "minus1"), (6, 4, 27, 0, "minus1"),  # misses -1, Vin+
    (32, 64, 27, 0, "batches"), (3, 8, 27, 0, "batches")])  # batch 2
def test_k1_bf16_cuda_matches_plain(cuda_device, cin, cout, k, offset,
                                    pattern):
    """K1-bf16 against the plain version in bf16 (f32 sums rounded once)
    on the rulebooks of ``_bf16_slots``: rows that miss at every offset
    are exactly zero. Two calls are bitwise equal; K1-bf16 counts its own
    launches, apart from K1's."""
    g = torch.Generator().manual_seed(cin * 100 + cout + k)
    b, vin = 2, 5000
    feat = torch.randn(b, vin, cin, generator=g).bfloat16()
    slots, vout = _bf16_slots(g, pattern, b, vin, k)
    w = (torch.randn(k, cin, cout, generator=g)
         * (k * cin) ** -0.5).bfloat16()
    ref = cuda_sparse_conv.gather_gemm_plain(feat, slots, w).float()
    buf = torch.empty(b * vin * cin + offset, dtype=torch.bfloat16,
                      device=cuda_device)
    dfeat = buf[offset:].view(b, vin, cin)
    dfeat.copy_(feat)
    dev = (dfeat, slots.to(cuda_device), w.to(cuda_device))
    before = (cuda_sparse_conv.launches, cuda_sparse_conv_bf16.launches)
    out = cuda_sparse_conv.gather_gemm(*dev)
    out2 = cuda_sparse_conv.gather_gemm(*dev)
    torch.cuda.synchronize()
    assert (cuda_sparse_conv.launches,
            cuda_sparse_conv_bf16.launches) == (before[0], before[1] + 2)
    assert out.dtype == torch.bfloat16 and torch.equal(out, out2)
    out = out.float().cpu()
    tol = 2.0 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
    assert ((out - ref).abs() <= tol).all()
    missed = ~((slots >= 0) & (slots < vin)).any(-1)
    assert missed.any() or pattern == "single"
    assert torch.equal(out[missed], torch.zeros_like(out[missed]))
    assert (out[~missed] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("k,cin,cout", [(27, 4, 16), (27, 64, 64),
                                        (3, 6, 4), (64, 40, 32)])
def test_k1_bf16_cuda_weight_arrangement(cuda_device, k, cin, cout):
    """The kernel's weight arrangement (``arrange_weight_kernel``) writes
    exactly the bytes of the plain ``arrange_weight``, padding zero."""
    g = torch.Generator().manual_seed(k + cin + cout)
    w = torch.randn(k, cin, cout, generator=g).bfloat16()
    cin_p, cout_p = cuda_sparse_conv_bf16.padded_widths(cin, cout)
    stream = torch.cuda.current_stream().cuda_stream
    out = cuda_sparse_conv_bf16.arrange_on_device(w.to(cuda_device), stream)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), cuda_sparse_conv_bf16.arrange_weight(
        w, cin_p, cout_p))


@pytest.mark.cuda
def test_k1_bf16_cuda_smem_mirror(cuda_device):
    """The CUDA source's stages and shared memory a block equal the
    Python mirror's for every width and K of the domain."""
    lib = cuda_sparse_conv_bf16._load()
    for cin in range(1, 65):
        for cout in (4, 8, 16, 32, 64):
            cin_p, cout_p = cuda_sparse_conv_bf16.padded_widths(cin, cout)
            assert lib.sparse_conv_bf16_stages(cin, cout) == (
                cuda_sparse_conv_bf16.stages_for(cin_p, cout_p))
            for k in (1, 27, 64):
                assert lib.sparse_conv_bf16_smem_bytes(k, cin, cout) == (
                    cuda_sparse_conv_bf16.smem_bytes(k, cin_p, cout_p))


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
@pytest.mark.parametrize("spread,overlapping", [(40.0, 0.01), (70.0, 0.004)])
def test_k3_cuda_matches_plain(cuda_device, spread, overlapping):
    """Within 1e-5 of the plain version, and exactly 0.0 on every pair
    the far-pair reject takes (most of them at these spreads)."""
    # the plain version runs on the card too: at 40 m from the origin
    # the Green's-theorem cross terms are ~1e3, so fp32 IoU moves by
    # ~1e-5 between the CPU's and the card's cos/sin alone
    rng = np.random.RandomState(3)
    boxes = torch.from_numpy(_random_boxes(rng, 1000, spread=spread))
    boxes = boxes.to(cuda_device)
    ref = cuda_iou.rotated_iou_matrix_plain(boxes, boxes)
    far = cuda_iou.far_pairs(boxes, boxes)
    before = cuda_iou.launches
    out = cuda_iou.rotated_iou_matrix(boxes, boxes)
    torch.cuda.synchronize()
    assert cuda_iou.launches == before + 1
    assert (ref > 0).float().mean() > overlapping
    assert far.float().mean() > 0.9
    assert torch.equal(out[far], torch.zeros_like(out[far]))
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    assert torch.equal(out, cuda_iou.rotated_iou_matrix(boxes, boxes))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 1), (33, 70), (70, 33), (1000, 7)])
def test_k3_cuda_ragged_shapes(cuda_device, n, m):
    """Tiles cut by the matrix's edge, rows strided over the grid."""
    rng = np.random.RandomState(n + m)
    b1 = torch.from_numpy(_random_boxes(rng, n, spread=6.0)).to(cuda_device)
    b2 = torch.from_numpy(_random_boxes(rng, m, spread=6.0)).to(cuda_device)
    out = cuda_iou.rotated_iou_matrix(b1, b2)
    ref = cuda_iou.rotated_iou_matrix_plain(b1, b2)
    assert out.shape == (n, m)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def _sweep_case(case, g, device):
    """(iou [n, n], valid [n]) on the CPU for a size or an edge case; the
    IoU of random boxes at a fixed density is computed on ``device``."""
    if case == "all_invalid":
        return torch.full((130, 130), 0.5), torch.zeros(130, dtype=torch.bool)
    if case == "every_pair_above":
        return torch.ones(130, 130), torch.arange(130) % 3 != 0
    if case == "no_pair_above":
        return torch.zeros(130, 130), torch.arange(130) % 3 != 0
    if case == "nan_entries":  # NaN compares false, as in the plain sweep
        iou = torch.rand(130, 130, generator=g)
        iou[torch.rand(130, 130, generator=g) < 0.5] = float("nan")
        return iou, torch.ones(130, dtype=torch.bool)
    boxes = torch.from_numpy(_random_boxes(
        np.random.RandomState(case), case, spread=12.0 * (case / 200) ** 0.5))
    boxes = boxes.to(device)
    iou = cuda_iou.rotated_iou_matrix_plain(boxes, boxes).cpu()
    return iou, torch.rand(case, generator=g) < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("case", [1, 63, 64, 65, 1000, 5000, "all_invalid",
                                  "every_pair_above", "no_pair_above",
                                  "nan_entries"])
@pytest.mark.parametrize("threshold", [0.01, 0.3])
def test_k4_cuda_matches_plain(cuda_device, case, threshold):
    """The keep mask equals the plain sweep's exactly; two launches (the
    mask build and the sweep) per call; two calls bitwise equal."""
    iou, valid = _sweep_case(case, torch.Generator().manual_seed(4),
                             cuda_device)
    ref = cuda_nms.greedy_suppress_plain(iou, valid, threshold)
    iou_d, valid_d = iou.to(cuda_device), valid.to(cuda_device)
    before = cuda_nms.launches
    keep = cuda_nms.greedy_suppress(iou_d, valid_d, threshold)
    torch.cuda.synchronize()
    assert cuda_nms.launches == before + 2
    assert torch.equal(keep.cpu(), ref)
    assert torch.equal(keep, cuda_nms.greedy_suppress(iou_d, valid_d,
                                                      threshold))
    if case in (1000, 5000):
        assert 0 < int(ref.sum()) < int(valid.sum())


@pytest.mark.cuda
def test_k4_cuda_refuses_n_above_max(cuda_device):
    n = cuda_nms.MAX_N + 1
    iou = torch.empty((n, n), device=cuda_device)  # 9.7 GB, never read
    with pytest.raises(ValueError, match=f"n={n}"):
        cuda_nms.greedy_suppress(
            iou, torch.ones(n, dtype=torch.bool, device=cuda_device), 0.5)


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


def _pp_points(seed, rows=32768):
    """A ``make_kitti_scene`` frame in xyres_16's padded points buffer,
    plus 150 points in one pillar (more than its T slots) and 200 on
    cell boundaries (float32 multiples of 0.16 m from the corner)."""
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 432, (200, 2)).astype(np.float32)
    step = np.float32(0.16)
    points = np.concatenate([
        make_kitti_scene(rng)[0],
        rng.uniform([4.97, 0.97, -1.5, 0], [5.11, 1.11, 0.5, 1], (150, 4)),
        np.stack([step * cells[:, 0], np.float32(-39.68) + step * cells[:, 1],
                  rng.uniform(-1.7, -0.2, 200), rng.uniform(0, 1, 200)], 1),
    ]).astype(np.float32)
    buf = np.zeros((rows, 4), np.float32)
    buf[:len(points)] = points
    return torch.from_numpy(buf), len(points)


@pytest.mark.cuda
@pytest.mark.parametrize("max_voxels", [12000, 2000])  # fits; overflows
def test_pillarize_and_voxelize_cuda_match_cpu(cuda_device, max_voxels):
    pts, n = _pp_points(0)
    args = (n, PP_VOXEL, PP_RANGE[:3], PP_GRID, max_voxels, PP_T)
    flat_cpu = pp_fast.flat_pillarize(pts, *args)
    flat_gpu = pp_fast.flat_pillarize(pts.to(cuda_device), *args)
    for a, b in zip(flat_gpu, flat_cpu):
        assert torch.equal(a.cpu(), b)
    assert int(flat_cpu[4].max()) == PP_T
    if max_voxels == 2000:
        assert int(flat_cpu[5]) == 2000
    vox_cpu = tvox.voxelize(pts, *args)
    vox_gpu = tvox.voxelize(pts.to(cuda_device), *args)
    for a, b in zip(vox_gpu, vox_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_flat_pfn_bev_cuda_matches_cpu(cuda_device):
    g = torch.Generator().manual_seed(0)
    vfe = get_vfe_class("PillarFeatureNetOld")(
        num_input_features=4, num_filters=(64,), voxel_size=PP_VOXEL,
        pc_range=PP_RANGE).eval()
    with torch.no_grad():
        for name, p in vfe.state_dict().items():
            if name.endswith("linear.weight"):
                p.copy_(torch.randn(p.shape, generator=g) / p.shape[1] ** 0.5)
            elif name.endswith("running_var") or name.endswith("bn.weight"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
            else:  # bn.bias, running_mean
                p.copy_(torch.rand(p.shape, generator=g) * 0.2 - 0.1)
    pts, n = _pp_points(1)
    flat = pp_fast.flat_pillarize(pts, n, PP_VOXEL, PP_RANGE[:3], PP_GRID,
                                  12000, PP_T)
    with torch.no_grad():
        ref = pp_fast.flat_pfn_bev(vfe, *flat[:5], max_points_per_voxel=PP_T,
                                   grid_size=PP_GRID)
        vfe.to(cuda_device)
        out = pp_fast.flat_pfn_bev(
            vfe, *(t.to(cuda_device) for t in flat[:5]),
            max_points_per_voxel=PP_T, grid_size=PP_GRID)
    assert ref.shape == (64, 496, 432) and ref.abs().max() > 1e-2
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-5)


# car.fhd's voxel generator (configs/car.fhd.config)
FHD_VOXEL = (0.05, 0.05, 0.1)
FHD_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
FHD_GRID = (1408, 1600, 40)
FHD_VOXELS = 40000
FHD_T = 5


def _fhd_coords(max_voxels=FHD_VOXELS):
    """A ``make_kitti_scene`` frame voxelized at car.fhd's grid (CPU)."""
    points = torch.from_numpy(make_kitti_scene(np.random.RandomState(3))[0])
    keep = ((points[:, :3] >= torch.tensor(FHD_RANGE[:3]))
            & (points[:, :3] < torch.tensor(FHD_RANGE[3:]))).all(1)
    points = points[keep]
    _, coords, _, _ = tvox.voxelize(points, points.shape[0], FHD_VOXEL,
                                    FHD_RANGE[:3], FHD_GRID, max_voxels,
                                    FHD_T)
    return coords


@pytest.mark.cuda
@pytest.mark.parametrize("name,nz,ny,nx", [
    ("SpMiddleFHD", 40, 1600, 1408),        # car.fhd at full width
    ("SpMiddleFHDPeople", 40, 1600, 1408),
    ("SpMiddleFHDLite", 40, 1600, 1408),
    ("SpMiddleFHDLiteHRZ", 80, 400, 352),   # taller z, random voxels
    ("SpMiddleFHDHRZ", 80, 400, 352),
    ("SpMiddle2K", 80, 400, 352),
])
def test_device_rulebooks_cuda_equal_cpu(cuda_device, name, nz, ny, nx):
    """``build_device_plan`` on the card: every scale's coords, slots and
    counts exactly the CPU's."""
    from second_tpu_torch.models import sparse_middle as tsm

    shape = (nz + 1, ny, nx)
    if nz == 40:
        coords = _fhd_coords()
    else:
        rng = np.random.RandomState(4)
        lin = rng.choice(nz * ny * nx, 12000, replace=False)
        coords = torch.full((FHD_VOXELS, 3), -1, dtype=torch.int32)
        coords[:12000] = torch.from_numpy(np.stack(
            [lin // (ny * nx), lin // nx % ny, lin % nx], -1).astype(np.int32))
    scales = tsm.plan_scales(name, (1, nz, ny, nx, 4), FHD_VOXELS)
    plans = []
    for dev in ("cpu", cuda_device):
        grid = tsparse.from_voxel_coords(
            torch.zeros(1, FHD_VOXELS, 1, device=dev),
            coords[None].to(dev), shape)
        plans.append(tsm.build_device_plan(grid, scales))
    (cpu, cpu_counts), (card, card_counts) = plans
    assert sorted(cpu) == sorted(card) and cpu
    for key, value in cpu.items():
        assert torch.equal(card[key].cpu(), value), key
    assert torch.equal(card_counts.cpu(), cpu_counts)


def _device_route_captures(device, mixed_precision):
    """car.fhd on the device route captured in a CUDA graph: its replay
    gives the eager run's detections exactly."""
    from second_tpu_torch.configs import load_pipeline_config
    from second_tpu_torch.core.inference import (
        InferenceContext,
        example_to_device,
    )
    from second_tpu_torch.models.voxelnet import predict

    cfg = load_pipeline_config("configs/car.fhd.config")
    cfg.train_config.enable_mixed_precision = mixed_precision
    ctx = InferenceContext()
    ctx.build(cfg, device=device, device_voxelize=True)
    ctx.init_random(0)
    example = ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(0))[0])
    ex = example_to_device(example, device)
    net, spec = ctx.parts["net"], ctx.parts["spec"]

    def run():
        with torch.no_grad():
            voxels, num_points, coords = ctx.route.voxelizer(
                ex["points"], ex["points_count"])
            return predict(spec, net(voxels, num_points, coords), ex)

    _, eager = ctx.run(example)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert int(eager["valid"].sum()) > 0
    for key, value in eager.items():
        assert torch.equal(out[key], value), key


@pytest.mark.cuda
def test_device_route_inference_captures_in_cuda_graph(cuda_device):
    """car.fhd inference on the device route (points -> the voxelizer ->
    device rulebooks -> the network -> predict) forces no host sync:
    it captures in a CUDA graph, whose replay gives the eager run's
    detections exactly."""
    _device_route_captures(cuda_device, mixed_precision=False)


@pytest.mark.cuda
def test_bf16_device_route_inference_captures_in_cuda_graph(cuda_device):
    """The same under mixed precision: K1-bf16, the bf16 dense tail and
    RPN capture too."""
    before = cuda_sparse_conv_bf16.launches
    _device_route_captures(cuda_device, mixed_precision=True)
    assert cuda_sparse_conv_bf16.launches > before


@pytest.mark.cuda
def test_res8x_request_runs_every_conv_on_k1(cuda_device, monkeypatch):
    """The nuScenes residual network serves a 10-sweep frame on the voxel
    route: each of its 21 sparse convs (conv_input, 8 blocks' 16, the 4
    strided ones, the 128-channel ones among them) is one K1 launch, no
    conv3d runs and no plain gather; no stage drops a site; the
    detections carry labels of the 10 classes."""
    from benchmark.gen import nusc_scenes
    from second_tpu_torch.core.inference import InferenceContext

    ctx = InferenceContext()
    ctx.build("configs/nuscenes/all.res8x.config", cuda_device)
    ctx.init_random(0)
    points = nusc_scenes.make_frame(np.random.default_rng([23, 1, 0]),
                                    34720, 5)[0]
    plain = []
    monkeypatch.setattr(cuda_sparse_conv, "gather_gemm_plain",
                        lambda *a, **k: plain.append(1))
    conv3d = []
    inner3d = torch.nn.functional.conv3d
    monkeypatch.setattr(torch.nn.functional, "conv3d",
                        lambda *a, **k: conv3d.append(1) or inner3d(*a, **k))
    before = cuda_sparse_conv.launches
    ex = ctx.get_inference_input_dict({"token": "t"}, points)
    assert ex["voxels"].shape == (1, 60000, 10, 4)
    _, dets, counts = ctx._run(ex)
    torch.cuda.synchronize()
    assert cuda_sparse_conv.launches - before == 21
    assert plain == [] and conv3d == []
    counts = counts.cpu().numpy()
    assert counts.shape == (1, 4, 2)
    assert np.all(counts[..., 0] <= counts[..., 1])
    assert counts[0, 0, 0] > 60000
    out = ctx.inference(ex)[0]
    assert 0 < len(out["scores"]) <= 83
    assert np.all((out["label_preds"] >= 0) & (out["label_preds"] < 10))
