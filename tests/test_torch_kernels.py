"""The port's kernels (K1 sparse conv, K2 its weight gradient, K3
rotated IoU, K4 greedy NMS) and the sparse conv's autograd Function
against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are held
to the Pallas kernels in interpret mode and to the JAX package's plain
paths. The CUDA kernels themselves are held to their plain versions on
the card by ``tests/test_torch_cuda.py``.

Tolerances: K1 1e-4 (fp32 sums of K*Cin products in another order, as
the JAX package's own banded-vs-gather tests); K3 1e-5 in fp32 against
Pallas and against the fp64 ``core.rotated_iou`` (the port computes
each pair centred on its first box, Pallas in scene coordinates, so
Pallas is compared at 1e-5 within 4 m of the origin where both are
accurate, and only at 1e-2 at full range, where Pallas drifts),
1e-9 in fp64 against the core; K4 exact (a keep mask); K2 and the
conv's gradients 1e-5 of the largest magnitude (fp32 sums in another
order); the transpose rulebook exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.core.rotated_iou import rotated_iou_matrix
from second_tpu.ops import banded_sparse as bs
from second_tpu.ops import nms as jnms
from second_tpu.ops import sparse as jsparse
from second_tpu.ops.pallas_iou import rotated_iou_matrix_pallas
from second_tpu.ops.pallas_nms import greedy_suppress_pallas

from second_tpu_torch.ops import (
    cuda_iou,
    cuda_nms,
    cuda_sparse_conv,
    cuda_sparse_conv_dw,
)
from second_tpu_torch.ops import sparse as tsparse


def _random_grid(rng, b, v, c, shape, density):
    d, h, w = shape
    feats = np.zeros((b, v, c), np.float32)
    coords = np.full((b, v, 3), -1, np.int32)
    for bi in range(b):
        n = min(int(v * density), v)
        lin = np.sort(rng.choice(d * h * w, size=n, replace=False))
        coords[bi, :n] = np.stack(
            [lin // (h * w), (lin % (h * w)) // w, lin % w], -1)
        feats[bi, :n] = rng.randn(n, c)
    return feats, coords


def _torch_grid(feats, coords, shape):
    return tsparse.from_sorted_voxel_coords(
        torch.from_numpy(feats), torch.from_numpy(coords), shape)


# --------------------------------------------------------------- K1


@pytest.mark.parametrize("kernel_size", [(3, 3, 3), (3, 1, 1)])
def test_k1_subm_matches_jax(kernel_size):
    rng = np.random.RandomState(0)
    b, v, c, cout = 1, 128, 16, 32
    shape = (6, 16, 16)
    feats, coords = _random_grid(rng, b, v, c, shape, density=0.9)
    jgrid = jsparse.from_voxel_coords(
        jnp.asarray(feats), jnp.asarray(coords), shape)
    slots, found = jsparse.build_subm_rulebook(jgrid, kernel_size)
    k = int(np.prod(kernel_size))
    w = (rng.randn(k, c, cout) * 0.1).astype(np.float32)
    bias = (rng.randn(cout) * 0.01).astype(np.float32)

    ref = np.asarray(jsparse.subm_conv(
        jgrid, (slots, found), jnp.asarray(w), jnp.asarray(bias)).features)
    tslots = torch.from_numpy(np.array(slots, np.int32))
    out = tsparse.subm_conv(_torch_grid(feats, coords, shape), tslots,
                            torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_allclose(out.features.numpy(), ref, rtol=1e-4,
                               atol=1e-4)

    # the kernel's own contract (no masking) against the Pallas kernel
    plan = bs.build_banded_plan(slots, found, v_in=v, kx=kernel_size[2],
                                cor_capacity=512)
    pallas = np.asarray(bs.banded_conv(jnp.asarray(feats), plan,
                                       jnp.asarray(w), jnp.asarray(bias),
                                       interpret=True))
    plain = cuda_sparse_conv.gather_gemm(
        torch.from_numpy(feats), tslots, torch.from_numpy(w),
        torch.from_numpy(bias)).numpy()
    valid = np.asarray(jgrid.valid)
    np.testing.assert_allclose(plain[valid], pallas[valid], rtol=1e-4,
                               atol=1e-4)


def test_k1_strided_matches_jax():
    rng = np.random.RandomState(1)
    b, v, c, cout = 1, 128, 8, 16
    shape = (6, 16, 16)
    kernel, stride, pad = (3, 3, 3), (2, 2, 2), (1, 1, 1)
    feats, coords = _random_grid(rng, b, v, c, shape, density=0.8)
    jgrid = jsparse.from_voxel_coords(
        jnp.asarray(feats), jnp.asarray(coords), shape)
    jout = jsparse.downsample_active_set(jgrid, kernel, stride, pad,
                                         out_capacity=256)
    ilin, ok, k = jsparse.sparse_conv_queries(jgrid, jout, kernel, stride,
                                              pad)
    slots, found = jsparse._lookup(jgrid.lin, ilin, ok, jgrid.sentinel)
    vout = jout.lin.shape[-1]
    slots = slots.reshape(b, vout, k)
    w = (rng.randn(k, c, cout) * 0.1).astype(np.float32)

    ref = np.asarray(jsparse.sparse_conv_apply(
        jgrid, jout, slots, jnp.asarray(w)).features)
    tslots = torch.from_numpy(np.array(slots, np.int32))
    tout_grid = tsparse.from_sorted_voxel_coords(
        None, torch.from_numpy(np.array(jout.coords)), jout.shape)
    out = tsparse.sparse_conv_apply(_torch_grid(feats, coords, shape),
                                    tout_grid, tslots, torch.from_numpy(w))
    assert np.asarray(jout.valid).sum() > 0
    np.testing.assert_allclose(out.features.numpy(), ref, rtol=1e-4,
                               atol=1e-4)

    plan = bs.build_banded_plan(slots, found.reshape(b, vout, k), v_in=v,
                                kx=kernel[2], cor_capacity=1024)
    pallas = np.asarray(bs.banded_conv(jnp.asarray(feats), plan,
                                       jnp.asarray(w), interpret=True))
    plain = cuda_sparse_conv.gather_gemm(
        torch.from_numpy(feats), tslots, torch.from_numpy(w)).numpy()
    valid = np.asarray(jout.valid)
    np.testing.assert_allclose(plain[valid], pallas[valid], rtol=1e-4,
                               atol=1e-4)


def test_k1_miss_slots_read_zero():
    """Slots equal to Vin (the planner's miss) or outside [0, Vin) read a
    zero row; the CPU wrapper launches nothing."""
    feat = torch.ones(1, 3, 4)
    slots = torch.tensor([[[0, 3], [5, -1]]], dtype=torch.int32)
    w = torch.ones(2, 4, 8)
    before = cuda_sparse_conv.launches
    out = cuda_sparse_conv.gather_gemm(feat, slots, w)
    assert cuda_sparse_conv.launches == before
    np.testing.assert_array_equal(out[0, 0].numpy(), np.full(8, 4.0))
    np.testing.assert_array_equal(out[0, 1].numpy(), np.zeros(8))


def test_tf32_round_is_round_to_nearest():
    """``tf32_round`` keeps 10 mantissa bits, rounds to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``."""
    rng = np.random.RandomState(8)
    x = (rng.randn(10000) * 10.0 ** rng.uniform(-8, 8, 10000)).astype(
        np.float32)
    r = cuda_sparse_conv.tf32_round(torch.from_numpy(x)).numpy()
    assert (r.view(np.int32) & 0x1FFF == 0).all()
    rel = np.abs(r.astype(np.float64) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -11
    ties = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                     1.0 + 2.0 ** -12], np.float32)
    np.testing.assert_array_equal(
        cuda_sparse_conv.tf32_round(torch.from_numpy(ties)).numpy(),
        np.array([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0], np.float32))


@pytest.mark.parametrize("k,cin,cout", [(27, 4, 16), (27, 64, 64)])
def test_k1_3xtf32_meets_tolerance_one_pass_does_not(k, cin, cout):
    """Why K1 and K2 run three TF32 passes: at car.fhd's depths K*Cin =
    108 and 1728, with features ~ N(0, 1) and weights of variance
    1/(K*Cin) (the smoke's scales), the 3xTF32 sum stays within K1's 1e-4
    of the largest magnitude of an fp64 reference, and one TF32 pass is
    at least ten times further off."""
    rng = np.random.RandomState(9)
    a = rng.randn(4096, k * cin).astype(np.float32)
    w = (rng.randn(k * cin, cout) * (k * cin) ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    err3 = np.abs(cuda_sparse_conv.matmul_3xtf32(at, wt).double().numpy()
                  - ref).max()
    err1 = np.abs(cuda_sparse_conv.matmul_3xtf32(at, wt, passes=1)
                  .double().numpy() - ref).max()
    tol = 1e-4 * max(1.0, np.abs(ref).max())
    print(f"K*Cin = {k * cin}: 3xTF32 max err {err3:.3e}, one TF32 pass "
          f"{err1:.3e}, K1 tolerance {tol:.3e}: one pass "
          f"{'misses' if err1 > tol else 'meets'} it")
    assert err3 <= tol
    assert err1 >= 10 * err3


# --------------------------------------------------------------- K3


def _random_boxes(rng, n, spread=10.0, origin=(0.0, 0.0)):
    return np.stack([rng.uniform(0, spread, n) + origin[0],
                     rng.uniform(0, spread, n) + origin[1],
                     rng.uniform(0.5, 4, n), rng.uniform(0.5, 4, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


def test_k3_matches_pallas_and_core():
    rng = np.random.RandomState(0)
    b1, b2 = _random_boxes(rng, 60, 4.0), _random_boxes(rng, 50, 4.0)
    pallas = np.asarray(rotated_iou_matrix_pallas(
        jnp.asarray(b1), jnp.asarray(b2), interpret=True))
    core = rotated_iou_matrix(b1.astype(np.float64), b2.astype(np.float64))
    before = cuda_iou.launches
    plain = cuda_iou.rotated_iou_matrix(torch.from_numpy(b1),
                                        torch.from_numpy(b2)).numpy()
    assert cuda_iou.launches == before
    assert (core > 0).mean() > 0.3  # overlaps, not an all-zero matrix
    np.testing.assert_allclose(plain, pallas, atol=1e-5)
    np.testing.assert_allclose(plain, core, atol=1e-5)
    plain64 = cuda_iou.rotated_iou_matrix_plain(
        torch.from_numpy(b1).double(), torch.from_numpy(b2).double())
    np.testing.assert_allclose(plain64.numpy(), core, atol=1e-9)


def test_k3_fp32_far_from_origin():
    """Boxes 60-70 m out, where car.fhd's NMS runs: computing each pair
    centred on its first box keeps fp32 within 1e-5 of the fp64 core (in
    scene coordinates the Green's cross terms reach ~1e3 and fp32 loses
    up to ~1e-3 of IoU)."""
    rng = np.random.RandomState(6)
    b1 = _random_boxes(rng, 80, 6.0, origin=(62.0, 32.0))
    b2 = _random_boxes(rng, 70, 6.0, origin=(62.0, 32.0))
    core = rotated_iou_matrix(b1.astype(np.float64), b2.astype(np.float64))
    plain = cuda_iou.rotated_iou_matrix(torch.from_numpy(b1),
                                        torch.from_numpy(b2)).numpy()
    assert (core > 0).mean() > 0.1
    np.testing.assert_allclose(plain, core, atol=1e-5)


@pytest.mark.parametrize("seed,origin", [(6, (62.0, 32.0)),
                                         (7, (64.0, -39.0)),
                                         (8, (64.0, 34.0))])
def test_k3_full_range_port_vs_pallas(seed, origin):
    """At the far corners of car.fhd's range the port and the Pallas
    kernel part ways, and the port is the accurate one. Pallas computes
    in scene coordinates and is expected off the fp64 core by up to
    ~4e-3 of IoU there (6.7e-4 / 1.0e-3 / 3.7e-3 at these origins); the
    port stays within 1e-5 in fp32 and 1e-9 in fp64. So port vs Pallas
    is held only to 1e-2, below the 0.3-0.7 NMS thresholds but not
    car.fhd's 0.01, where the two may suppress differently."""
    rng = np.random.RandomState(seed)
    b1 = _random_boxes(rng, 80, 6.0, origin=origin)
    b2 = _random_boxes(rng, 70, 6.0, origin=origin)
    core = rotated_iou_matrix(b1.astype(np.float64), b2.astype(np.float64))
    pallas = np.asarray(rotated_iou_matrix_pallas(
        jnp.asarray(b1), jnp.asarray(b2), interpret=True))
    port = cuda_iou.rotated_iou_matrix(torch.from_numpy(b1),
                                       torch.from_numpy(b2)).numpy()
    port64 = cuda_iou.rotated_iou_matrix_plain(
        torch.from_numpy(b1).double(), torch.from_numpy(b2).double()).numpy()
    assert (core > 0).mean() > 0.1
    port_err = np.abs(port - core).max()
    pallas_err = np.abs(pallas - core).max()
    assert port_err <= 1e-5
    np.testing.assert_allclose(port64, core, atol=1e-9)
    np.testing.assert_allclose(port, pallas, atol=1e-2)
    assert pallas_err > port_err


def _near_reject_boundary(rng, k1, k2, kind, origin, aligned):
    """k1 boxes at ``origin`` sharing one circumradius r1, and k2 boxes
    whose centres lie (r1 + r2) * FAR_SCALE * (1 + v) away, |v| <= 1e-2
    (an eighth exactly on it): every one of the k1 x k2 pairs sits near
    the reject boundary. ``aligned`` puts every second box in one
    direction and aims a corner of each box at the other's centre, where
    the gap between the boxes is smallest."""
    def sides(r, n):
        if kind == "elongated":
            a = rng.choice([1e-3, np.pi / 2 - 1e-3], n)
        else:
            a = rng.uniform(0, np.pi / 2, n)
        return 2 * r * np.cos(a), 2 * r * np.sin(a)

    if kind == "tiny":
        r1 = rng.choice([2.0 ** -10, 1e-3, 1e-2, 1e-6])
        r2 = rng.choice([2.0 ** -10, 2.0 ** -11, 1e-3, 1e-2, 0.5], k2)
    elif kind == "zero":
        r1 = rng.choice([0.0, 1.0])
        r2 = rng.choice([0.0, 0.0, 1.0, 2.0 ** -11], k2)
    else:
        r1 = rng.uniform(0.3, 5)
        r2 = rng.uniform(0.3, 5, k2)
    w1, l1 = sides(r1, k1)
    w2, l2 = sides(r2, k2)
    if kind == "zero":
        w1[::2] = 0.0  # segments, and points when r1 = 0
    v = rng.choice([-1, 1], k2) * 10.0 ** rng.uniform(-8, -2, k2)
    v[:k2 // 8] = 0.0
    dist = (r1 + r2) * cuda_iou.FAR_SCALE * (1 + v)
    phi = np.full(k2, rng.uniform(-np.pi, np.pi)) if aligned else \
        rng.uniform(-np.pi, np.pi, k2)
    x2 = origin[0] + dist * np.cos(phi)
    y2 = origin[1] + dist * np.sin(phi)
    if aligned:  # corner k points at atan2(DY[k] l, DX[k] w) - angle
        dx, dy = np.array([-.5, -.5, .5, .5]), np.array([-.5, .5, .5, -.5])
        k = rng.randint(4, size=k1)
        a1 = np.arctan2(dy[k] * l1, dx[k] * w1) - phi[0]
        k = rng.randint(4, size=k2)
        a2 = np.arctan2(dy[k] * l2, dx[k] * w2) - (phi + np.pi)
    else:
        a1 = rng.uniform(-np.pi, np.pi, k1)
        a2 = rng.uniform(-np.pi, np.pi, k2)
    b1 = np.stack([np.full(k1, origin[0]), np.full(k1, origin[1]), w1, l1,
                   a1], 1)
    b2 = np.stack([x2, y2, w2, l2, a2], 1)
    return (torch.from_numpy(b1.astype(np.float32)),
            torch.from_numpy(b2.astype(np.float32)))


def test_k3_far_pairs_are_exactly_zero():
    """The kernel writes 0.0 for the pairs ``far_pairs`` rejects, without
    clipping them: the full arithmetic in float32 must give exactly 0.0
    on every such pair. 100352 pairs near the reject boundary, at the
    origin and 60-75 m out, every angle, corners aimed at each other,
    elongated, tiny and zero-size boxes. A zero-size box scores the
    other box's area wherever it lies, so the reject must spare it."""
    rng = np.random.RandomState(12)
    kinds = ["normal", "elongated", "tiny", "zero"]
    rejected = spared = 0
    for blk in range(8):
        rad = 0.0 if blk < 2 else rng.uniform(60, 75)
        ang = rng.uniform(-np.pi, np.pi)
        b1, b2 = _near_reject_boundary(
            rng, 112, 112, kinds[blk % 4], (rad * np.cos(ang),
                                            rad * np.sin(ang)),
            aligned=blk % 2 == 0)
        far = cuda_iou.far_pairs(b1, b2)
        plain = cuda_iou.rotated_iou_matrix_plain(b1, b2)
        assert (plain[far] == 0.0).all()
        assert not (far & (plain > 0)).any()
        rejected += int(far.sum())
        spared += int((~far & (plain > 0)).sum())
    assert 0.2 < rejected / (8 * 112 * 112) < 0.8
    assert spared > 0  # the zero-size boxes' pairs


DEGENERATE = {
    # the cases of tests/test_rotated_iou_oracle.py::test_degenerate_cases
    "identical": ([1.0, 2.0, 3.0, 4.0, 0.7], [1.0, 2.0, 3.0, 4.0, 0.7]),
    "touching_edge": ([0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 0.0, 2.0, 2.0, 0.0]),
    "touching_corner": ([0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 2.0, 2.0, 2.0, 0.0]),
    "contained": ([0.0, 0.0, 1.0, 1.0, 0.3], [0.0, 0.0, 4.0, 4.0, 1.1]),
    "zero_area": ([0.0, 0.0, 0.0, 2.0, 0.5], [0.0, 0.0, 2.0, 2.0, 0.0]),
    "parallel_offset": ([0.0, 0.0, 2.0, 2.0, 0.0], [1.0, 0.0, 2.0, 2.0, 0.0]),
    "cross": ([0.0, 0.0, 1.0, 3.0, 0.0], [0.0, 0.0, 3.0, 1.0, 0.0]),
    "rot90": ([0.5, -0.5, 2.0, 2.0, 0.0], [0.5, -0.5, 2.0, 2.0, np.pi / 2]),
}


@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_k3_degenerate_cases(case):
    """fp32, as the kernel runs: the boundary rules need the exact zeros
    fp32 rounding gives these boxes (shifted by ~1e-16, as cos(pi/2) in
    fp64 does, two coincident edges would both count)."""
    a, b = DEGENERATE[case]
    boxes = np.array([a, b], np.float32)  # pairs (a,a) (a,b) (b,a) (b,b)
    core = rotated_iou_matrix(boxes.astype(np.float64),
                              boxes.astype(np.float64))
    pallas = np.asarray(rotated_iou_matrix_pallas(
        jnp.asarray(boxes), jnp.asarray(boxes), interpret=True))
    plain = cuda_iou.rotated_iou_matrix(
        torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    assert np.isfinite(plain).all()
    np.testing.assert_allclose(plain, core, atol=1e-5)
    np.testing.assert_allclose(plain, pallas, atol=1e-5)


# --------------------------------------------------------------- K4


def _nms_inputs(rng, n):
    """A score-ordered IoU matrix of random boxes and a validity mask."""
    boxes = _random_boxes(rng, n, spread=12.0)
    iou = rotated_iou_matrix(boxes.astype(np.float64),
                             boxes.astype(np.float64)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    return iou, valid


@pytest.mark.parametrize("threshold", [0.01, 0.3])
def test_k4_matches_pallas_and_fori(threshold):
    rng = np.random.RandomState(2)
    iou, valid = _nms_inputs(rng, 200)
    pallas = np.asarray(greedy_suppress_pallas(
        jnp.asarray(iou), jnp.asarray(valid), threshold, interpret=True))
    fori = np.asarray(jnms._greedy_suppress(
        jnp.asarray(iou), jnp.asarray(valid), threshold))
    before = cuda_nms.launches
    keep = cuda_nms.greedy_suppress(torch.from_numpy(iou),
                                    torch.from_numpy(valid), threshold)
    assert cuda_nms.launches == before
    keep = keep.numpy()
    assert 0 < keep.sum() < valid.sum()  # some kept, some suppressed
    np.testing.assert_array_equal(keep, pallas)
    np.testing.assert_array_equal(keep, fori)


def _bitmask_sweep_model(iou, valid, threshold):
    """numpy model of the kernel's word-blocked sweep
    (``csrc/greedy_nms.cu``): masks of the columns j > i in 64-bit words,
    a scan of each word's 64 bits in rank order with its diagonal words,
    and the kept rows' masks ORed into the later words."""
    n = iou.shape[0]
    words = -(-n // 64)
    cols = np.arange(64 * words)
    sup = np.zeros((n, 64 * words), bool)
    sup[:, :n] = iou > threshold
    sup &= cols[None, :] > np.arange(n)[:, None]
    mask = [[sum(1 << int(b) for b in np.flatnonzero(sup[i, 64 * w:][:64]))
             for w in range(words)] for i in range(n)]
    removed = [sum(1 << b for b in range(64)
                   if 64 * w + b >= n or not valid[64 * w + b])
               for w in range(words)]
    keep = np.zeros(n, bool)
    for w in range(words):
        cur = removed[w]
        for b in range(64):
            if not cur >> b & 1:
                cur |= mask[64 * w + b][w]
        kept = [b for b in range(64) if not cur >> b & 1]
        keep[[64 * w + b for b in kept]] = True
        for w2 in range(w + 1, words):
            for b in kept:
                removed[w2] |= mask[64 * w + b][w2]
    return keep


def _sparse_iou(rng, n):
    """[n, n] with ~8 entries per row in (0, 1), some NaN, the rest 0."""
    iou = rng.uniform(size=(n, n)) * (rng.uniform(size=(n, n)) < 8 / n)
    iou[rng.uniform(size=(n, n)) < 1 / n] = np.nan
    return iou.astype(np.float32)


SWEEP_EDGES = {
    "all_invalid": lambda n: (np.full((n, n), 0.5, np.float32),
                              np.zeros(n, bool)),
    "every_pair_above": lambda n: (np.ones((n, n), np.float32),
                                   np.arange(n) % 3 != 0),
    "no_pair_above": lambda n: (np.zeros((n, n), np.float32),
                                np.arange(n) % 3 != 0),
}


@pytest.mark.parametrize("case", [(n, thr) for n in (1, 2, 63, 64, 65, 200,
                                                     1000)
                                  for thr in (0.01, 0.3)]
                         + sorted(SWEEP_EDGES), ids=str)
def test_k4_bitmask_sweep_model_matches_plain(case):
    if case in SWEEP_EDGES:
        iou, valid = SWEEP_EDGES[case](130)
        thr = 0.3
    else:
        n, thr = case
        rng = np.random.RandomState(n)
        iou, valid = _sparse_iou(rng, n), rng.uniform(size=n) < 0.9
    ref = cuda_nms.greedy_suppress_plain(torch.from_numpy(iou),
                                         torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(_bitmask_sweep_model(iou, valid, thr),
                                  ref.numpy())
    if case == "every_pair_above":
        assert ref.sum() == 1
    elif case == "no_pair_above":
        np.testing.assert_array_equal(ref.numpy(), valid)
    elif case != "all_invalid" and case[0] >= 200:
        assert 0 < ref.sum() < valid.sum()  # kept and suppressed both


# --------------------------------------------------------------- K2 and
# the sparse conv's backward


def _conv_case(kind, seed, b=2, v=160, c=8, cout=16):
    """A random sparse grid and its JAX rulebook: (feats, coords, shape,
    slots [B, Vout, K] with miss = V, the output grid, kernel)."""
    rng = np.random.RandomState(seed)
    shape = (6, 16, 16)
    feats, coords = _random_grid(rng, b, v, c, shape, density=0.8)
    jgrid = jsparse.from_voxel_coords(
        jnp.asarray(feats), jnp.asarray(coords), shape)
    kernel = (3, 3, 3)
    k = int(np.prod(kernel))
    if kind == "subm":
        slots, found = jsparse.build_subm_rulebook(jgrid, kernel)
        jout = jgrid
    else:
        jout = jsparse.downsample_active_set(jgrid, kernel, (2, 2, 2),
                                             (1, 1, 1), out_capacity=256)
        ilin, ok, _ = jsparse.sparse_conv_queries(
            jgrid, jout, kernel, (2, 2, 2), (1, 1, 1))
        slots, found = jsparse._lookup(jgrid.lin, ilin, ok, jgrid.sentinel)
        vout = jout.lin.shape[-1]
        slots, found = slots.reshape(b, vout, k), found.reshape(b, vout, k)
    slots = np.array(slots, np.int32)
    assert (slots == v).any() and (slots < v).any()  # hits and misses
    w = (rng.randn(k, c, cout) * 0.1).astype(np.float32)
    dout = rng.randn(b, slots.shape[1], cout).astype(np.float32)
    dout *= np.asarray(jout.valid)[..., None]  # masked rows carry none
    return dict(feats=feats, coords=coords, shape=shape, slots=slots,
                found=np.asarray(found), w=w, dout=dout, jgrid=jgrid,
                jout=jout, v=v)


def _jax_conv(case, feats, w):
    if case["jgrid"] is case["jout"]:
        return jsparse.subm_conv(
            case["jgrid"]._replace(features=feats),
            (jnp.asarray(case["slots"]), None), w).features
    return jsparse.sparse_conv_apply(
        case["jgrid"]._replace(features=feats), case["jout"],
        jnp.asarray(case["slots"]), w).features


def _close(a, ref, rel):
    """max |a - ref| <= rel * max |ref| (fp32 sums in another order)."""
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(a, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_k2_plain_matches_pallas_and_grad(kind):
    """K2's plain version against the Pallas ``_banded_dw`` in interpret
    mode and against jax.grad of the gather path, miss slots included."""
    case = _conv_case(kind, seed=11)
    feats, slots, dout, w = (case["feats"], case["slots"], case["dout"],
                             case["w"])
    before = cuda_sparse_conv_dw.launches
    dw = cuda_sparse_conv_dw.sparse_conv_dw(
        torch.from_numpy(feats), torch.from_numpy(slots),
        torch.from_numpy(dout)).numpy()
    assert cuda_sparse_conv_dw.launches == before

    plan = bs.build_banded_plan(jnp.asarray(slots), jnp.asarray(case["found"]),
                                v_in=case["v"], kx=3, cor_capacity=2048)
    pallas = bs._banded_dw(jnp.asarray(feats), jnp.asarray(dout), plan,
                           interpret=True)
    _close(dw, pallas, 1e-5)

    def loss(w_):
        return jnp.sum(_jax_conv(case, jnp.asarray(feats), w_)
                       * jnp.asarray(dout))

    _close(dw, jax.grad(loss)(jnp.asarray(w)), 1e-5)


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_transpose_rulebook_matches_jax(kind):
    case = _conv_case(kind, seed=12)
    slots, v = case["slots"], case["v"]
    out = tsparse.transpose_rulebook(torch.from_numpy(slots), v).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(bs.transpose_rulebook(jnp.asarray(slots), v_in=v)))
    host = np.stack([bs.host_transpose_rulebook(s, v_in=v) for s in slots])
    np.testing.assert_array_equal(out, host)


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_sparse_conv_function_gradcheck(kind):
    """The autograd Function's K1 input gradient and K2 weight gradient
    (plain versions here) against finite differences, in float64
    (``fast_mode``: the Jacobians compared along random directions,
    instead of one backward per output element)."""
    case = _conv_case(kind, seed=13, b=1, v=48, c=3, cout=4)
    feats = torch.from_numpy(case["feats"]).double().requires_grad_()
    w = torch.from_numpy(case["w"]).double().requires_grad_()
    slots = torch.from_numpy(case["slots"])
    assert torch.autograd.gradcheck(
        lambda f, w_: tsparse.SparseConvFunction.apply(
            f, w_, slots, kind == "subm"), (feats, w), fast_mode=True)


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_sparse_conv_function_grads_match_jax(kind):
    """dfeat and dW of the port's subm_conv / sparse_conv_apply against
    jax.grad of the JAX package's, on the active rows (inactive rows get
    no gradient on either side)."""
    case = _conv_case(kind, seed=14)
    feats = torch.from_numpy(case["feats"]).requires_grad_()
    w = torch.from_numpy(case["w"]).requires_grad_()
    slots = torch.from_numpy(case["slots"])
    grid = _torch_grid(case["feats"], case["coords"], case["shape"])
    grid = grid._replace(features=feats)
    if kind == "subm":
        out = tsparse.subm_conv(grid, slots, w)
    else:
        jout = case["jout"]
        out_grid = tsparse.from_sorted_voxel_coords(
            None, torch.from_numpy(np.array(jout.coords)), jout.shape)
        out = tsparse.sparse_conv_apply(grid, out_grid, slots, w)
    dout = case["dout"]
    (out.features * torch.from_numpy(dout)).sum().backward()

    def loss(f, w_):
        return jnp.sum(_jax_conv(case, f, w_) * jnp.asarray(dout))

    gf, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(case["feats"]),
                                             jnp.asarray(case["w"]))
    active = np.asarray(case["jgrid"].valid)
    _close(feats.grad.numpy()[active], np.asarray(gf)[active], 1e-5)
    _close(w.grad.numpy(), gw, 1e-5)
