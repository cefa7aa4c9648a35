"""Mixed precision (bf16) of the port against the JAX package on the CPU.

The JAX package's mixed precision (``compute_dtype="bfloat16"``, which
``train_config.enable_mixed_precision`` selects) casts the voxel
features and each sparse weight to bf16 in the sparse middle, runs the
RPN's convs in bf16 and its heads in f32 on the backbone's output cast
back; batch norm keeps f32 statistics. The port makes the same casts
(no autocast). Here K1's bf16 plain version, ``MaskedBatchNorm``, the
RPNs, the sparse residual blocks, the small car.fhd and all.fhd slices
and PointPillars (inference and three train steps) run through both
packages, with weights through ``from_flax`` and inputs from numpy
seeds; and a sparse middle's bf16 training is refused. The kernels run
as their plain versions here.

Tolerances, with their reasons:

* K1's plain version: each element within one bf16 ulp of JAX's
  (2^-7 of its magnitude) plus 1e-5 of the largest magnitude. Both sum
  exact f32 products of the same bf16 values in another order and round
  once, so a sum near a rounding boundary may round the other way.
* ``MaskedBatchNorm``: bf16 out of bf16 in; values within one bf16 ulp
  (f32 statistics summed in another order); the running statistics f32
  within 1e-6.
* The RPNs and residual blocks: outputs in JAX's dtype, within 1.5e-2
  of JAX's largest magnitude (bf16 convs round where JAX's do, but a
  one-ulp difference in one layer moves the next).
* Whole networks: preds within 1.5e-2 of the largest magnitude of JAX's
  bf16 preds, about twice the JAX package's own bf16-against-f32 error
  on the small car.fhd config; the port's bf16 preds within 1.5e-2 of
  its f32 preds. Detections as ``test_torch_slice`` matches
  them (label, boxes within 1e-2 and scores within 1e-3: a bf16 pred
  carries 2^-8 of its size), paired without regard to order.
* PointPillars training: the loss within 1e-2 relative and every
  gradient within 5e-2 relative L2 of JAX's, each step started from
  JAX's state (``test_torch_pp_train``'s re-sync and its open ReLUs),
  except where bf16 does not resolve a gradient that finely (JAX's own
  bf16 gradient 2e-2 or more off the f32 one, ``UNRESOLVED``): there the
  port's lies within twice JAX's distance of the f32 gradient.
* Detections: random weights score many candidates within bf16's
  rounding of each other, so greedy NMS may keep another near-duplicate
  in one package; at least 0.9 of the larger set pair up (PointPillars'
  ~300 detections pair 292 of 294).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from second_tpu.builders import network_builder as jnb
from second_tpu.configs import loads_pipeline_config as jloads
from second_tpu.core.inference import InferenceContext as JaxContext
from second_tpu.models import pp_fast as jpp
from second_tpu.models import sparse_resnet as jresnet
from second_tpu.models import voxelnet as jvoxelnet
from second_tpu.models.layers import MaskedBatchNorm as JaxBN
from second_tpu.models.registry import get_rpn_class as jget_rpn
from second_tpu.models.voxelnet import compute_loss as jcompute_loss
from second_tpu.ops import banded_sparse as bs
from second_tpu.ops import sparse as jsparse
from second_tpu.train import optimizer as jopt
from second_tpu.train.__main__ import example_convert
from second_tpu.train.state import TrainState as JaxTrainState
from second_tpu.train.state import _expand_targets as jexpand
from second_tpu.train.state import make_train_step as jmake_train_step
from second_tpu.train.state import make_voxelizer_fn as jmake_voxelizer

from second_tpu_torch.builders import network_builder as tnb
from second_tpu_torch.configs import loads_pipeline_config as tloads
from second_tpu_torch.core.inference import (
    InferenceContext,
    example_to_device,
)
from second_tpu_torch.models import sparse_resnet as tresnet
from second_tpu_torch.models.layers import MaskedBatchNorm
from second_tpu_torch.models.registry import get_rpn_class as tget_rpn
from second_tpu_torch.ops import cuda_sparse_conv_bf16 as k1b
from second_tpu_torch.ops import sparse as tsparse
from second_tpu_torch.ops.cuda_sparse_conv import gather_gemm_plain
from second_tpu_torch.train import optimizer as topt
from second_tpu_torch.train.__main__ import train
from second_tpu_torch.train.state import (
    forward_loss,
    make_train_step,
    make_voxelizer_fn,
)
from second_tpu_torch.utils.from_flax import from_flax

from test_torch_modules import _random_variables
from test_torch_multiclass import VOXELS as ALL_VOXELS
from test_torch_multiclass import frame_points, reduced_text
from test_torch_pointpillars import SMALL_PP_CONFIG, small_pp_points
from test_torch_pp_train import MAX_VOXELS as PP_VOXELS
from test_torch_pp_train import _point_batch, pp_train_variables
from test_torch_slice import SMALL_FHD_CONFIG, host_plan_of, random_variables
from test_torch_train import _sync_to_jax
from test_torch_zoo import RPN_BASE, _nchw, _nhwc

BF16_ULP = 2.0 ** -7
PREDS_TOL = 1.5e-2
BOX_TOL = 1e-2
SCORE_TOL = 1e-3
LOSS_RTOL = 1e-2
GRAD_L2_TOL = 5e-2
# a gradient whose JAX bf16 value lies this far (L2) or further from the
# f32 gradient is not resolved by bf16 to GRAD_L2_TOL: two programs'
# bf16 roundings part it by up to about twice that (on these inputs a
# nearly cancelling batch-norm bias, 0.19-0.60 off, and some of the
# RPN's middle convolutions, 0.02-0.10). Where the port parts from JAX
# by more than GRAD_L2_TOL, the tensor must be such a one and the port's
# gradient within twice JAX's distance of the f32 gradient (the port's
# f32 network on the same weights, JAX's f32 twin within 1e-4,
# test_torch_pp_train)
UNRESOLVED = 2e-2
DET_MATCH_MIN = 0.9


def mixed(text):
    """A pipeline config's text with ``enable_mixed_precision`` set."""
    cfg = tloads(text)
    cfg.train_config.enable_mixed_precision = True
    return cfg.to_text()


def f32(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_torch(x):
    """A JAX bf16 array as a torch bf16 tensor (exact, through f32)."""
    return torch.from_numpy(f32(x).copy()).bfloat16()


def assert_within_ulp(out, ref, what):
    out, ref = f32(out), f32(ref)
    tol = BF16_ULP * np.abs(ref) + 1e-5 * np.abs(ref).max()
    excess = np.abs(out - ref) - tol
    assert np.abs(ref).max() > 0, what
    assert excess.max() <= 0, (
        f"{what}: {int((excess > 0).sum())} elements beyond one bf16 ulp, "
        f"worst by {excess.max():.3e}")


def assert_rel(out, ref, tol, what):
    out, ref = f32(out), f32(ref)
    scale = np.abs(ref).max()
    assert scale > 1e-3, what  # not a trivially zero map
    err = np.abs(out - ref).max() / scale
    assert err <= tol, f"{what}: {err:.3e} of the largest value > {tol}"


# ------------------------------------------- (a) K1's bf16 plain version

def _random_grid(rng, b, v, c, shape, density):
    """A JAX SparseGrid of bf16 features on random active sites."""
    d, h, w = shape
    feats = np.zeros((b, v, c), np.float32)
    coords = np.full((b, v, 3), -1, np.int32)
    for bi in range(b):
        n = min(int(v * density), v)
        lin = np.sort(rng.choice(d * h * w, size=n, replace=False))
        coords[bi, :n] = np.stack([lin // (h * w), (lin % (h * w)) // w,
                                   lin % w], 1)
        feats[bi, :n] = rng.randn(n, c)
    return jsparse.from_voxel_coords(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(coords), shape)


@pytest.mark.parametrize("conv", ["subm", "down"])
def test_k1_bf16_plain_matches_jax(conv):
    """K1's plain version in bf16 against the JAX package's gather path
    (``subm_conv``, ``sparse_conv_apply``) and its Pallas K1
    (``banded_conv``, interpret mode), on the same rulebooks."""
    rng = np.random.RandomState(3)
    b, v, cin, cout = 1, 256, 16, 32
    kernel = (3, 3, 3)
    grid = _random_grid(rng, b, v, cin, (6, 24, 24), density=0.8)
    w = jnp.asarray(rng.randn(27, cin, cout) * 0.1, jnp.bfloat16)
    if conv == "subm":
        slots, found = jsparse.build_subm_rulebook(grid, kernel)
        ref = jsparse.subm_conv(grid, (slots, found), w).features
        valid = np.asarray(grid.valid)
    else:
        stride, pad = (2, 2, 2), (1, 1, 1)
        out_grid = jsparse.downsample_active_set(grid, kernel, stride, pad,
                                                 out_capacity=512)
        ilin, ok, _ = jsparse.sparse_conv_queries(grid, out_grid, kernel,
                                                  stride, pad)
        slots, found = jsparse._lookup(grid.lin, ilin, ok, grid.sentinel)
        slots = slots.reshape(b, 512, 27)
        found = found.reshape(b, 512, 27)
        ref = jsparse.sparse_conv_apply(grid, out_grid, slots, w).features
        valid = np.asarray(out_grid.valid)
    plan = bs.build_banded_plan(slots, found, v_in=v, kx=kernel[2],
                                cor_capacity=512)
    banded = bs.banded_conv(grid.features, plan, w, interpret=True)
    assert ref.dtype == banded.dtype == jnp.bfloat16

    out = gather_gemm_plain(bf16_torch(grid.features),
                            torch.from_numpy(np.asarray(slots, np.int32)),
                            bf16_torch(w))
    assert out.dtype == torch.bfloat16
    assert_within_ulp(out.float().numpy()[valid], f32(ref)[valid],
                      f"{conv} vs the gather path")
    assert_within_ulp(out.float().numpy()[valid], f32(banded)[valid],
                      f"{conv} vs banded_conv")


def test_sparse_convs_promote_as_jax():
    """``ops.sparse``'s convs on bf16 features with f32 weights run in
    f32 and return bf16, as JAX's ``dot_general(...).astype(dtype)``;
    mixed dtypes never reach the kernel wrapper."""
    rng = np.random.RandomState(4)
    grid = _random_grid(rng, 1, 256, 8, (4, 16, 16), density=0.7)
    w = rng.randn(27, 8, 16).astype(np.float32) * 0.1
    slots, found = jsparse.build_subm_rulebook(grid, (3, 3, 3))
    ref = jsparse.subm_conv(grid, (slots, found), jnp.asarray(w)).features
    tgrid = tsparse.SparseGrid(
        bf16_torch(grid.features), torch.from_numpy(np.asarray(grid.lin)),
        torch.from_numpy(np.asarray(grid.coords)), grid.shape)
    out = tsparse.subm_conv(tgrid, torch.from_numpy(
        np.asarray(slots, np.int32)), torch.from_numpy(w)).features
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    assert_within_ulp(out, ref, "bf16 features, f32 weights")
    with pytest.raises(ValueError, match="share a dtype"):
        gather_gemm_plain(tgrid.features, torch.zeros(1, 256, 27,
                                                      dtype=torch.int32),
                          torch.from_numpy(w))


# K1-bf16's host-side arithmetic (csrc/sparse_conv_bf16.cu): the weight
# arrangement its bulk copies read, its shared memory, and where its
# producers put each gathered row against where its wgmma descriptors
# read (K-major core matrices: leading byte offset 128, stride byte
# offset Cin_p * 16, a k16 slice 256 bytes on)

K1B_WIDTHS = [(4, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
              (3, 8), (6, 4), (40, 32), (64, 8)]


@pytest.mark.parametrize("cin,cout", K1B_WIDTHS)
def test_k1_bf16_weight_arrangement_round_trips(cin, cout):
    """``arrange_weight`` back to [K, Cin, Cout] is the weight; the
    padding is zero; each element sits where the CUDA source's
    ``arrange_weight_kernel`` index arithmetic puts it."""
    k = 27
    w = torch.from_numpy(np.random.RandomState(cin + cout).randn(
        k, cin, cout).astype(np.float32)).bfloat16()
    cin_p, cout_p = k1b.padded_widths(cin, cout)
    warr = k1b.arrange_weight(w, cin_p, cout_p)
    assert warr.shape == (k, cout_p // 8, cin_p // 8, 8, 8)
    assert torch.equal(k1b.unarrange_weight(warr, cin, cout), w)
    flat = warr.reshape(-1).float().numpy()
    i = np.arange(flat.size)
    per_k = cin_p * cout_p
    kk, rem = i // per_k, i % per_k
    blk, e = rem >> 6, rem & 63
    n = (blk // (cin_p // 8)) * 8 + (e >> 3)
    c = (blk % (cin_p // 8)) * 8 + (e & 7)
    inside = (c < cin) & (n < cout)
    wf = w.float().numpy()
    assert np.array_equal(flat[inside], wf[kk[inside], c[inside], n[inside]])
    assert not flat[~inside].any()


def test_k1_bf16_shared_memory_fits_every_shape():
    """A block's shared memory stays within the 227 KB a block can opt
    in to for every padded width, K <= 64 and ring depth in [4, 8]; the
    ring takes 4-8 stages of its target size."""
    limit = 227 * 1024
    for cin_p in (16, 32, 64):
        for cout_p in (8, 16, 32, 64):
            stages = k1b.stages_for(cin_p, cout_p)
            assert k1b.MIN_STAGES <= stages <= k1b.MAX_STAGES
            stage = k1b.TILE_ROWS * cin_p * 2 + cin_p * cout_p * 2
            assert (stages * stage <= k1b.RING_BYTES
                    or stages == k1b.MIN_STAGES)
            for k in range(1, 65):
                for s in range(k1b.MIN_STAGES, k1b.MAX_STAGES + 1):
                    assert k1b.smem_bytes(k, cin_p, cout_p, s) <= limit
    # car.fhd's widest conv: 4 stages of 64 rows x 128 bytes and an 8 KB
    # W[k], the slots of 27 offsets x 65 words
    assert k1b.TILE_ROWS == 64
    assert k1b.smem_bytes(27, 64, 64) == 256 + 7040 + 4 * 16384


def _a_chunk(cin, feat_offset):
    """The widest copy (bf16 elements) ``launch`` picks."""
    a = 8
    while a > 1 and (cin % a or (2 * feat_offset) % (2 * a)):
        a //= 2
    return a


def _produce_stage(feat, slot_k, cin, cin_p, a_chunk, producers=128):
    """A stage's A bytes as the CUDA producers write them: every producer
    thread's copy steps (the compile-time path for full 16-byte rows,
    else the generic one), misses zero-filled, Cin's padding zero."""
    sbo = cin_p * 16
    tm = k1b.TILE_ROWS
    stage = np.zeros(tm * cin_p * 2, np.uint8)
    rows = feat.view(np.uint8).reshape(feat.shape[0], -1)
    step = producers // 8
    cpr = cin // a_chunk
    for pt in range(producers):
        rsub = pt & 7
        for p in range(pt >> 3, tm // 8 * cpr, step):
            rg, c = p // cpr, (p % cpr) * a_chunk
            row = slot_k[rg * 8 + rsub]
            dst = rg * sbo + (c >> 3) * 128 + rsub * 16 + (c & 7) * 2
            n = 2 * a_chunk
            stage[dst:dst + n] = rows[row, 2 * c:2 * c + n] if row >= 0 else 0
    return stage


def _descriptor_read(buf, start, n_rows, sbo):
    """The [n_rows, 16] bf16 slice a K-major, unswizzled wgmma
    descriptor at byte ``start`` reads: element (r, c) at
    (r // 8) * sbo + (c // 8) * 128 + (r % 8) * 16 + (c % 8) * 2."""
    r, c = np.meshgrid(np.arange(n_rows), np.arange(16), indexing="ij")
    at = start + (r // 8) * sbo + (c // 8) * 128 + (r % 8) * 16 + (c % 8) * 2
    lo, hi = buf[at].astype(np.uint16), buf[at + 1].astype(np.uint16)
    return lo | (hi << 8)


@pytest.mark.parametrize("cin,cout,offset", [
    (4, 16, 0), (16, 32, 0), (32, 32, 0), (64, 64, 0), (3, 8, 0),
    (6, 4, 0), (40, 32, 0), (16, 16, 1)])
def test_k1_bf16_stage_layout_matches_its_descriptors(cin, cout, offset):
    """What the producers write into a stage, read back through each
    consumer warpgroup's A descriptors (its 64 rows, 8 row groups in) of
    each k16 slice, is the offset's gathered rows (zero for misses and in
    Cin's padding); ``arrange_weight``'s bytes read through the B
    descriptors are W[k]. So each wgmma multiplies the gathered rows by
    W[k]."""
    rng = np.random.RandomState(cin * 7 + cout)
    vin, k, tm = 300, 27, k1b.TILE_ROWS
    feat = rng.randn(vin, cin).astype(np.float32)
    feat16 = torch.from_numpy(feat).bfloat16()
    bits = feat16.view(torch.int16).numpy().view(np.uint16)
    slot_k = rng.randint(-1, vin, tm)
    slot_k[rng.rand(tm) < 0.3] = -1
    cin_p, cout_p = k1b.padded_widths(cin, cout)
    a_chunk = _a_chunk(cin, offset)
    stage = _produce_stage(bits, slot_k, cin, cin_p, a_chunk)
    want = np.zeros((tm, cin_p), np.uint16)
    want[slot_k >= 0, :cin] = bits[slot_k[slot_k >= 0]]
    sbo = cin_p * 16
    got = np.concatenate([
        np.concatenate([_descriptor_read(stage, wg * 8 * sbo + 256 * j, 64,
                                         sbo)
                        for j in range(cin_p // 16)], 1)
        for wg in range(tm // 64)], 0)
    assert np.array_equal(got, want)

    w = torch.from_numpy(rng.randn(k, cin, cout).astype(np.float32))
    warr = k1b.arrange_weight(w.bfloat16(), cin_p, cout_p)
    wbits = warr.view(torch.int16).numpy().view(np.uint16)
    for kk in (0, k - 1):
        buf = wbits[kk].reshape(-1).view(np.uint8)
        b_t = np.concatenate([_descriptor_read(buf, 256 * j, cout_p,
                                               cin_p * 16)
                              for j in range(cin_p // 16)], 1)
        ref = np.zeros((cout_p, cin_p), np.uint16)
        ref[:cout, :cin] = w.bfloat16()[kk].t().contiguous().view(
            torch.int16).numpy().view(np.uint16)
        assert np.array_equal(b_t, ref)


# ---------------------------------------------- (b) MaskedBatchNorm in bf16

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_masked_batch_norm_bf16_matches_jax(train):
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(2, 50, 16) * 3 + 1, jnp.bfloat16)
    mask = rng.rand(2, 50) < 0.7
    jmod = JaxBN()
    variables = _random_variables(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), x), seed=6)
    if train:
        ref, upd = jmod.apply(variables, x, mask=jnp.asarray(mask),
                              use_running_average=False,
                              mutable=["batch_stats"])
    else:
        ref = jmod.apply(variables, x, mask=jnp.asarray(mask),
                         use_running_average=True)
    tmod = MaskedBatchNorm(16)
    tmod.load_state_dict(from_flax(variables), strict=True)
    tmod.train(train)
    with torch.no_grad():
        out = tmod(bf16_torch(x), mask=torch.from_numpy(mask))
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    assert_within_ulp(out, ref, "batch norm")
    assert tmod.running_mean.dtype == torch.float32
    if train:
        stats = upd["batch_stats"]
        np.testing.assert_allclose(tmod.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(tmod.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-6)


# ----------------------------------------------------- (c) the RPNs in bf16

RPNS = {
    "RPNV2": ("RPNV2", dict()),
    "RPNV2_groupnorm": ("RPNV2", dict(use_groupnorm=True, num_groups=4)),
    "ResNetRPN": ("ResNetRPN", dict()),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(RPNS))
def test_rpns_bf16_match_jax(case, train):
    """bf16 in (the sparse middle's output), f32 heads out."""
    name, extra = RPNS[case]
    kwargs = {**RPN_BASE, **extra}
    x = jnp.asarray(np.random.RandomState(34).randn(2, 16, 16, 12),
                    jnp.bfloat16)
    jmod = jget_rpn(name)(**kwargs, compute_dtype="bfloat16")
    tmod = tget_rpn(name)(**kwargs, compute_dtype=torch.bfloat16)
    variables = _random_variables(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), x), seed=35)
    tmod.load_state_dict(from_flax(variables), strict=True)

    def run(v, a):
        if train:
            return jmod.apply(v, a, train=True, mutable=["batch_stats"])[0]
        return jmod.apply(v, a, train=False)

    ref = jax.jit(run)(variables, x)
    tmod.train(train)
    with torch.no_grad():
        out = tmod(_nchw(bf16_torch(x)))
    for key in ref:
        assert ref[key].dtype == jnp.float32, key
        assert out[key].dtype == torch.float32, key
        assert_rel(_nhwc(out[key]), ref[key], PREDS_TOL, key)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_transposed_conv_bf16_input_gradient_on_the_cpu(stride):
    """A bf16 deblock's input gradient on the CPU against the same block
    in f32 on the same (bf16) values, within bf16's 5e-2 in L2: torch's
    CPU bf16 ``conv_transpose2d`` returns a wrong one at stride 4, so
    ``ConvBNReLU`` runs it in f32 there and rounds once."""
    from second_tpu_torch.models.rpn import ConvBNReLU

    g = torch.Generator().manual_seed(stride)
    block = ConvBNReLU(32, 16, stride, stride, transpose=True,
                       compute_dtype=torch.bfloat16)
    with torch.no_grad():
        block.conv.weight.copy_(
            torch.randn(block.conv.weight.shape, generator=g).bfloat16())
    block32 = copy.deepcopy(block)
    block32.compute_dtype = None
    x = torch.randn(2, 32, 8, 8, generator=g).bfloat16().float()
    cot = torch.randn(2, 16, 8 * stride, 8 * stride, generator=g)
    grads = []
    for module, dtype in ((block, torch.bfloat16), (block32, torch.float32)):
        xi = x.to(dtype).requires_grad_(True)
        out = module.train()(xi)
        (grad,) = torch.autograd.grad((out.float() * cot).sum(), xi)
        grads.append(grad.float().numpy())
    assert _l2(*grads) <= GRAD_L2_TOL


@pytest.mark.parametrize("block", ["basic", "basic_downsample",
                                   "bottleneck"])
def test_sparse_blocks_bf16_promote_as_jax(block):
    """The residual blocks cast nothing, in either package: on bf16
    features the basic block stays bf16 unless its downsample (a dense
    layer with f32 weights) promotes the sum to f32; the bottleneck's
    first dense layer makes the rest f32."""
    rng = np.random.RandomState(8)
    cin = 8
    grid = _random_grid(rng, 1, 200, cin, (4, 16, 16), density=0.8)
    if block == "bottleneck":
        jmod, tmod = (jresnet.SparseBottleneck(planes=4),
                      tresnet.SparseBottleneck(cin, 4))
    else:
        planes = 16 if block == "basic_downsample" else cin
        jmod, tmod = (jresnet.SparseBasicBlock(planes=planes),
                      tresnet.SparseBasicBlock(cin, planes))
    rulebook = jsparse.build_subm_rulebook(grid, (3, 3, 3))
    variables = _random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), grid, rulebook)), seed=9)
    ref = jmod.apply(variables, grid, rulebook).features
    tmod.load_state_dict(from_flax(variables), strict=True)
    tgrid = tsparse.SparseGrid(
        bf16_torch(grid.features), torch.from_numpy(np.asarray(grid.lin)),
        torch.from_numpy(np.asarray(grid.coords)), grid.shape)
    with torch.no_grad():
        out = tmod.eval()(tgrid, torch.from_numpy(
            np.asarray(rulebook[0], np.int32))).features
    bf16_out = block == "basic"
    assert ref.dtype == (jnp.bfloat16 if bf16_out else jnp.float32)
    assert out.dtype == (torch.bfloat16 if bf16_out else torch.float32)
    assert_rel(out, ref, PREDS_TOL, block)


# ------------------------------------------- (d), (e) the sparse slices

def _detections_match(tdets, jdets, what):
    """``test_torch_slice``'s match with bf16 tolerances and without
    order: each detection of the larger set paired with one of the
    other's of its label, box within ``BOX_TOL`` and score within
    ``SCORE_TOL``, for at least ``DET_MATCH_MIN`` of them."""
    a, b = ((tdets, jdets) if len(tdets["scores"]) >= len(jdets["scores"])
            else (jdets, tdets))
    n = len(a["scores"])
    assert n > 0, f"{what}: no detection"
    used = np.zeros(len(b["scores"]), bool)
    paired = 0
    for box, score, label in zip(a["box3d_lidar"], a["scores"],
                                 a["label_preds"]):
        ok = (~used & (b["label_preds"] == label)
              & (np.abs(b["scores"] - score) <= SCORE_TOL)
              & (np.abs(b["box3d_lidar"] - box) <= BOX_TOL).all(1))
        if ok.any():
            used[np.argmax(ok)] = True
            paired += 1
    assert paired >= DET_MATCH_MIN * n, (
        f"{what}: {paired} of {n} detections paired")


@pytest.fixture(scope="module")
def fhd():
    """The small car.fhd slice with mixed precision in both packages
    (``test_torch_slice``'s weights and frame), and the port's f32 twin
    on the same weights."""
    text = mixed(SMALL_FHD_CONFIG)
    jctx = JaxContext()
    jctx.build(jloads(text))
    voxels = jctx.config.eval_input_reader.preprocess.max_number_of_voxels
    variables = random_variables(jctx.parts["net"], voxels)
    jctx._state = JaxTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=(), global_step=jnp.zeros((), jnp.int32))
    tctx = InferenceContext()
    tctx.build(tloads(text), device="cpu")
    tctx.load_flax_variables(variables)
    f32ctx = InferenceContext()
    f32ctx.build(tloads(SMALL_FHD_CONFIG), device="cpu")
    f32ctx.load_flax_variables(variables)
    from test_torch_slice import small_fhd_points

    return jctx, tctx, f32ctx, variables, small_fhd_points()


def _jax_preds(net, variables, example, plan):
    """The JAX network's preds of a port request's ``example`` on the
    host ``plan`` of its voxels (``host_plan_of``)."""
    ex = {k: jnp.asarray(v) for k, v in example_convert(example).items()}
    plan = {k: jnp.asarray(v) for k, v in plan.items()}
    assert plan, "the config must exercise the host planner"
    return jax.jit(lambda v, e, p: net.apply(
        v, e["voxels"], e["num_points"], e["coordinates"], train=False,
        sparse_plan=p))(variables, ex, plan), ex


def test_fhd_builds_in_bf16(fhd):
    _, tctx, f32ctx, _, _ = fhd
    net = tctx.parts["net"]
    assert net.compute_dtype == torch.bfloat16
    assert net.middle_feature_extractor.compute_dtype == torch.bfloat16
    assert net.rpn.compute_dtype == torch.bfloat16
    assert f32ctx.parts["net"].compute_dtype is None
    assert all(p.dtype == torch.float32 for p in net.parameters())
    parts = tnb.build_network(tloads(SMALL_FHD_CONFIG), "cpu",
                              compute_dtype="bfloat16")
    assert parts["net"].compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        tnb.build_network(tloads(SMALL_FHD_CONFIG), "cpu",
                          compute_dtype="float16")


def test_fhd_bf16_preds_and_detections_match_jax(fhd):
    jctx, tctx, f32ctx, variables, points = fhd
    example = tctx.get_inference_input_dict({}, points)
    jpreds, _ = _jax_preds(jctx.parts["net"], variables, example,
                           host_plan_of(tctx, example))
    preds, _ = tctx.run(example)
    preds32, _ = f32ctx.run(f32ctx.get_inference_input_dict({}, points))
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        assert jpreds[key].dtype == jnp.float32
        assert preds[key].dtype == torch.float32
        assert_rel(preds[key], jpreds[key], PREDS_TOL, f"{key} vs JAX")
        assert_rel(preds[key], preds32[key], PREDS_TOL, f"{key} vs f32")
    jdets = jctx.inference(jctx.get_inference_input_dict({}, points))[0]
    tdets = tctx.inference(tctx.get_inference_input_dict({}, points))[0]
    _detections_match(tdets, jdets, "car.fhd")


def test_fhd_bf16_device_route_matches_host_route(fhd):
    """``device_voxelize=True``: the same voxels and rulebooks, so the
    same bf16 preds as the host voxels."""
    _, tctx, _, variables, points = fhd
    dctx = InferenceContext()
    dctx.build(tctx.config, device="cpu", device_voxelize=True)
    dctx.load_flax_variables(variables)
    host, _ = tctx.run(tctx.get_inference_input_dict({}, points))
    dev, _ = dctx.run(dctx.get_inference_input_dict({}, points))
    for key in host:
        assert_rel(dev[key], host[key], 1e-5, key)


def test_all_fhd_bf16_preds_and_detections_match_jax():
    """The reduced all.fhd (four classes) with mixed precision, under
    multi-class NMS."""
    text = mixed(reduced_text(multiclass_nms=True))
    jparts = jnb.build_network(jloads(text), use_banded=False)
    variables = random_variables(jparts["net"], ALL_VOXELS, seed=5)
    ctx = InferenceContext()
    ctx.build(tloads(text), device="cpu")
    ctx.load_flax_variables(variables)
    f32ctx = InferenceContext()
    f32ctx.build(tloads(reduced_text(multiclass_nms=True)), device="cpu")
    f32ctx.load_flax_variables(variables)
    example = ctx.get_inference_input_dict({}, frame_points(0))
    jpreds, ex = _jax_preds(jparts["net"], variables, example,
                            host_plan_of(ctx, example))
    preds, dets = ctx.run(example)
    preds32, _ = f32ctx.run(example)
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        assert_rel(preds[key], jpreds[key], PREDS_TOL, f"{key} vs JAX")
        assert_rel(preds[key], preds32[key], PREDS_TOL, f"{key} vs f32")
    jdets = jax.jit(lambda p, a: jvoxelnet.predict(
        jparts["spec"], p, {"anchors": a}))(jpreds, ex["anchors"])
    valid = np.asarray(jdets["valid"])[0]
    tvalid = dets["valid"].numpy()[0]
    _detections_match(
        {k: dets[k].numpy()[0][tvalid] for k in
         ("box3d_lidar", "scores", "label_preds")},
        {k: np.asarray(jdets[k])[0][valid] for k in
         ("box3d_lidar", "scores", "label_preds")}, "all.fhd")


# ------------------------------------------------- (f) PointPillars in bf16

def test_pointpillars_bf16_inference_matches_jax():
    """The flat pillar path: the PFN and canvas in f32, the RPN in
    bf16, the heads f32."""
    text = mixed(SMALL_PP_CONFIG)
    jctx = JaxContext()
    jctx.build(jloads(text))
    variables = random_variables(
        jctx.parts["net"], jctx.config.eval_input_reader.preprocess
        .max_number_of_voxels)
    jctx._state = JaxTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=(), global_step=jnp.zeros((), jnp.int32))
    tctx = InferenceContext()
    tctx.build(tloads(text), device="cpu")
    tctx.load_flax_variables(variables)
    assert tctx.flat_pp and tctx.parts["net"].rpn.compute_dtype == (
        torch.bfloat16)
    f32ctx = InferenceContext()
    f32ctx.build(tloads(SMALL_PP_CONFIG), device="cpu")
    f32ctx.load_flax_variables(variables)
    points = small_pp_points(7, boundary=False)
    jex = jctx.get_inference_input_dict({}, points)
    ex = {k: jnp.asarray(v) for k, v in example_convert(jex).items()}
    gen = jctx.parts["voxel_generator"]
    grid = tuple(int(g) for g in gen.grid_size)
    flat = jpp.flat_pillarize(
        ex["points"][0], ex["points_count"][0, 0],
        tuple(float(x) for x in gen.voxel_size),
        tuple(float(x) for x in gen.point_cloud_range[:3]),
        grid_size=grid, max_voxels=PP_VOXELS,
        max_points_per_voxel=int(gen.max_num_points_per_voxel))
    bev = jpp.flat_pfn_bev(
        variables, *flat[:5], num_filters=(64,),
        max_points_per_voxel=int(gen.max_num_points_per_voxel),
        voxel_size=tuple(gen.voxel_size), pc_range=tuple(
            gen.point_cloud_range), grid_size=grid, num_input_features=4,
        center_replaces_xy=True)
    assert bev.dtype == jnp.float32
    jpreds = jax.jit(lambda v, x: jctx.parts["net"].apply(
        v, x, method=lambda m, a: m.rpn(a, train=False)))(variables,
                                                          bev[None])
    example = tctx.get_inference_input_dict({}, points)
    preds, _ = tctx.run(example)
    preds32, _ = f32ctx.run(example)
    for key in ("box_preds", "cls_preds", "dir_cls_preds"):
        ref = f32(jpreds[key]).reshape(preds[key].shape)
        assert_rel(preds[key], ref, PREDS_TOL, f"{key} vs JAX")
        assert_rel(preds[key], preds32[key], PREDS_TOL, f"{key} vs f32")
    jdets = jctx.inference(jctx.get_inference_input_dict({}, points))[0]
    tdets = tctx.inference(example)[0]
    _detections_match(tdets, jdets, "PointPillars")


# The bf16 error against f32 of PointPillars' flat path, in the port
# against the JAX package's own on the same weights and frames (the
# measurement of tests/pp_bf16_margin.py at the reduced width). Both
# round at the same places: each RPN conv once to bf16 from f32 sums,
# batch norms in f32 rounded to bf16, the heads in f32. The f32 sums
# inside each conv run in another order in oneDNN and XLA, so a value
# near a bf16 rounding boundary rounds the other way in one package and
# such flips compound through the RPN's 16 layers: on the published
# width's frames 0-3 the port's error is 0.95-1.36 of JAX's
# (tests/pp_bf16_margin.py; PERF.md section 6), at this width up to
# 1.32. PP_MARGIN_RATIO bounds that; a cast in the wrong place takes the
# port past it (the heads in bf16: 1.58x on frame 8's box preds; batch
# norm's arithmetic in bf16: 1.55x on frame 7's).
PP_MARGIN_RATIO = 1.5


def test_pointpillars_bf16_error_matches_jax_error():
    """The port's bf16-vs-f32 error of each pred on two frames is at most
    ``PP_MARGIN_RATIO`` times the JAX package's on the same inputs (one
    torch thread: the parallel CPU kernels would oversubscribe the
    tier-1 run's workers)."""
    from pp_bf16_margin import PREDS, margins

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = margins(SMALL_PP_CONFIG, [small_pp_points(s, boundary=False)
                                         for s in (7, 8)])
    finally:
        torch.set_num_threads(threads)
    for i, row in enumerate(rows):
        for k in PREDS:
            e = row[k]
            assert 0 < e["jax"] < PREDS_TOL, (i, k, e)
            assert e["port"] <= PP_MARGIN_RATIO * e["jax"], (i, k, e)


def _l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grads(net, spec, example, voxelizer):
    """The loss's gradients of a copy of ``net`` (a forward in training
    mode moves the batch statistics)."""
    net = copy.deepcopy(net)
    loss = forward_loss(net, spec, example, voxelizer)["loss"]
    names, params = zip(*net.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def test_pointpillars_bf16_train_steps_match_jax():
    text = mixed(SMALL_PP_CONFIG)
    cfg = tloads(text)
    tparts = tnb.build_network(cfg, "cpu")
    jparts = jnb.build_network(jloads(text), use_banded=False)
    batch = _point_batch(cfg, tparts, jparts)
    jnet, jspec = jparts["net"], jparts["spec"]
    assert jnet.compute_dtype == "bfloat16"
    variables = pp_train_variables(jnet)
    tx, _, _ = jopt.build(cfg.train_config.optimizer, cfg.train_config.steps)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray,
                                                         variables), tx)
    jvox = jmake_voxelizer(jparts["voxel_generator"], PP_VOXELS)
    jstep = jmake_train_step(jnet, jspec, tx, voxelizer=jvox)
    jex = {k: jnp.asarray(v) for k, v in example_convert(batch).items()}

    @jax.jit
    def jgrads(state):
        ex = jexpand(jex, jspec.box_code_size)
        voxels, num_points, coords = jvox(ex["points"], ex["points_count"])

        def loss_fn(params):
            preds, _ = jnet.apply(
                {"params": params, "batch_stats": state.batch_stats},
                voxels, num_points, coords, train=True,
                mutable=["batch_stats"])
            return jcompute_loss(jspec, preds, ex)["loss"]
        return jax.grad(loss_fn)(state.params)

    net, spec = tparts["net"], tparts["spec"]
    assert net.rpn.compute_dtype == torch.bfloat16
    net.load_state_dict(from_flax(variables), strict=True)
    opt, lr_fn, mom_fn = topt.build(cfg.train_config.optimizer,
                                    cfg.train_config.steps,
                                    list(net.parameters()))
    tvox = make_voxelizer_fn(tparts["voxel_generator"], PP_VOXELS)
    step = make_train_step(net, spec, opt, lr_fn, mom_fn, voxelizer=tvox)
    tex = example_to_device(batch, "cpu")
    net32 = tnb.build_network(tloads(SMALL_PP_CONFIG), "cpu")["net"]
    for i in range(3):
        _sync_to_jax(net, opt, jstate)
        ref_grads = from_flax({"params": jgrads(jstate)})
        grads = _grads(net, spec, tex, tvox)
        assert sorted(grads) == sorted(ref_grads)
        grads32 = None  # the f32 gradients, where a tensor needs them
        for name, g in grads.items():
            assert g.dtype == torch.float32, name
            g, ref = g.numpy(), ref_grads[name].numpy()
            err = _l2(g, ref)
            if err <= GRAD_L2_TOL:
                continue
            if grads32 is None:
                net32.load_state_dict(net.state_dict())
                grads32 = _grads(net32, spec, tex, tvox)
            exact = grads32[name].numpy()
            ref_err = _l2(ref, exact)
            assert ref_err >= UNRESOLVED and _l2(g, exact) <= 2 * ref_err, (
                f"step {i} grad {name}: {err:.3e} from JAX's, JAX's own "
                f"{ref_err:.3e} and the port's {_l2(g, exact):.3e} from f32")
        jstate, jm = jstep(jstate, jex)
        m = step(tex)
        assert np.isfinite(float(m["loss"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        assert all(p.dtype == torch.float32 for p in net.parameters())
        assert all(mu.dtype == torch.float32 for mu in opt.mu)


# --------------------------------------- (g) sparse-middle training refused

def test_bf16_sparse_training_raises_naming_the_roadmap(tmp_path):
    """``make_train_step`` and ``train`` of a sparse middle under mixed
    precision raise before any step, naming ROADMAP.md and the JAX
    package's own failure; nothing falls back to f32."""
    cfg = tloads(mixed(SMALL_FHD_CONFIG))
    parts = tnb.build_network(cfg, "cpu")
    opt, lr_fn, mom_fn = topt.build(cfg.train_config.optimizer,
                                    cfg.train_config.steps,
                                    list(parts["net"].parameters()))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md section 3") as err:
        make_train_step(parts["net"], parts["spec"], opt, lr_fn, mom_fn)
    assert "sparse_middle.py:656-660" in str(err.value)
    config = tmp_path / "fhd.config"
    config.write_text(cfg.to_text())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train(str(config), str(tmp_path / "model"), device="cpu")
    assert not (tmp_path / "model").exists()
