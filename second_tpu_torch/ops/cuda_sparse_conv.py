"""K1: gather-GEMM sparse convolution (``csrc/sparse_conv.cu``).

Replaces the Pallas TPU kernel ``second_tpu/ops/banded_sparse.py``
``_banded_call_fused``. Both submanifold and strided convs are

    out[b, o] = bias + sum_k feat[b, slots[b, o, k]] @ W[k]

over a host-built rulebook ``slots`` [B, Vout, K]; a slot outside
[0, Vin) (the planner writes Vin) reads a zero row. What bounds the
kernel on the card and how it is laid out is in the CUDA source's
header. In bf16 (features and weights both bf16, no bias) the sums run
in f32 and are rounded once to bf16, as the JAX package's mixed
precision does; CUDA tensors then launch K1-bf16
(:mod:`.cuda_sparse_conv_bf16`).

:func:`gather_gemm` launches the kernel for CUDA tensors and runs
:func:`gather_gemm_plain` for CPU tensors; ``launches`` counts K1's
launches.
"""

import ctypes

import torch

from . import cuda_sparse_conv_bf16

KERNEL = "sparse_conv"
launches = 0

# a tile's offsets with a hit are one 64-bit mask in the kernel
MAX_OFFSETS = 64
# shared memory a block can opt in to on Hopper (232 448 bytes)
MAX_SMEM_BYTES = 227 * 1024
# K1's widest instantiations, Cout 128 from Cin in (32, 128] (the residual
# nuScenes middle's 128-channel stage); K1-bf16 and K2 stop at 64
WIDE_COUT = 128
NARROW_MAX = 64


def refuse_wide(name, cin, cout):
    """Raise for Cin or Cout above 64 in a kernel without the 128-wide
    instantiations (K1-bf16, K2), on any device."""
    if cin > NARROW_MAX or cout > NARROW_MAX:
        raise ValueError(
            f"{name}: Cin {cin} / Cout {cout}: only fp32 K1 runs widths "
            f"above {NARROW_MAX}; the bf16 forward and the weight gradient "
            "at 128 channels wait in ROADMAP.md queue 6")

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..csrc import build

        lib = build.load(KERNEL)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sparse_conv_launch.argtypes = [vp, vp, vp, vp, vp,
                                           i, i, i, i, i, i, vp]
        lib.sparse_conv_launch.restype = i
        lib.sparse_conv_smem_bytes.argtypes = [i, i, i]
        lib.sparse_conv_smem_bytes.restype = i
        _lib = lib
    return _lib


def gather_rows(feat, slots):
    """feat [B, Vin, C], slots [B, Vout, K] -> the rulebook's rows
    [B, Vout, K*C]; a slot outside [0, Vin) reads a zero row."""
    b, vin, cin = feat.shape
    _, vout, k = slots.shape
    slots = slots.long()
    slots = torch.where((slots >= 0) & (slots < vin), slots,
                        torch.full_like(slots, vin))
    slots = slots + (vin + 1) * torch.arange(
        b, device=slots.device)[:, None, None]
    feat_pad = torch.cat([feat, feat.new_zeros(b, 1, cin)], dim=1)
    return feat_pad.reshape(b * (vin + 1), cin)[slots.reshape(-1)].reshape(
        b, vout, k * cin)


def _compute_dtype(feat, weight, bias):
    """The dtype both operands must share; bf16 takes no bias (the
    port's convs have none)."""
    if feat.dtype != weight.dtype:
        raise ValueError(f"gather_gemm: feat and weight must share a dtype "
                         f"(both float32 or both bfloat16 for the kernels), "
                         f"got {feat.dtype} and {weight.dtype}")
    if feat.dtype == torch.bfloat16 and bias is not None:
        raise ValueError("gather_gemm: bfloat16 takes no bias")
    return feat.dtype


def gather_gemm_plain(feat, slots, weight, bias=None):
    """Plain PyTorch version: gather [B, Vout, K*Cin] then one
    [K*Cin, Cout] matmul (the JAX package's ``ops.sparse`` formulation);
    in bf16 the matmul runs in f32 and its result is rounded once."""
    k, cin, cout = weight.shape
    if _compute_dtype(feat, weight, bias) == torch.bfloat16:
        rows = gather_rows(feat, slots).float()
        return (rows @ weight.float().reshape(k * cin, cout)).to(
            torch.bfloat16)
    out = gather_rows(feat, slots) @ weight.reshape(k * cin, cout)
    if bias is not None:
        out = out + bias
    return out


def tf32_round(x):
    """fp32 -> the nearest TF32 value (10-bit mantissa), ties away from
    zero, on the int32 view: what ``cvt.rna.tf32.f32`` gives the kernels."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_3xtf32(a, b, passes=3):
    """``a @ b`` (fp32) as the kernels form it on the tensor cores: each
    operand split into hi = tf32(x) and lo = tf32(x - hi), then
    lo*hi + hi*lo + hi*hi with fp32 sums (``passes=1``: hi*hi only, a
    single TF32 pass). Products of TF32 values are exact in fp32. Used by
    the tests to show why the kernels keep three passes; nothing on the
    main path calls it."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def gather_gemm(feat, slots, weight, bias=None):
    """feat [B, Vin, Cin] f32, slots [B, Vout, K] int32, weight
    [K, Cin, Cout] f32, bias [Cout] or None -> [B, Vout, Cout] f32; or
    feat and weight bf16, no bias -> bf16 (f32 sums rounded once).

    CPU tensors take :func:`gather_gemm_plain`; CUDA tensors launch the
    kernel, K1 (Cin <= 64 and Cout a power of two in [4, 64], or Cout
    128 and Cin in (32, 128]; K <= 64) or K1-bf16 (Cin, Cout <= 64), or
    raise. Mixed dtypes raise, and so does bf16 above 64 channels on
    any device.
    """
    global launches
    dtype = _compute_dtype(feat, weight, bias)
    if dtype == torch.bfloat16:
        refuse_wide("gather_gemm (bf16)", weight.shape[-2], weight.shape[-1])
    if feat.device.type == "cpu":
        return gather_gemm_plain(feat, slots, weight, bias)
    if feat.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {feat.device}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gather_gemm: the kernels take float32 or "
                         f"bfloat16, got {dtype}")
    if feat.dim() != 3 or slots.dim() != 3 or weight.dim() != 3:
        raise ValueError("gather_gemm: want feat [B,V,C], slots [B,Vo,K], "
                         "weight [K,Ci,Co]")
    b, vin, cin = feat.shape
    bs, vout, k = slots.shape
    kw, cin_w, cout = weight.shape
    if bs != b or kw != k or cin_w != cin:
        raise ValueError(
            f"gather_gemm: shapes disagree: feat {tuple(feat.shape)}, "
            f"slots {tuple(slots.shape)}, weight {tuple(weight.shape)}")
    narrow = (1 <= cin <= NARROW_MAX and 4 <= cout <= NARROW_MAX
              and cout & (cout - 1) == 0)
    wide = cout == WIDE_COUT and NARROW_MAX // 2 < cin <= WIDE_COUT
    if not (narrow or wide):
        raise ValueError(f"gather_gemm: kernel takes Cin <= 64 and Cout a "
                         f"power of two in [4, 64], or Cout 128 and Cin in "
                         f"(32, 128], got {cin}, {cout}")
    if k > MAX_OFFSETS:
        raise ValueError(f"gather_gemm: kernel takes K <= {MAX_OFFSETS} "
                         f"offsets, got {k}")
    tensors = [("feat", feat, dtype), ("slots", slots, torch.int32),
               ("weight", weight, dtype)]
    if bias is not None:
        tensors.append(("bias", bias, torch.float32))
        if bias.shape != (cout,):
            raise ValueError(f"gather_gemm: bias shape {tuple(bias.shape)}")
    for name, t, want in tensors:
        if t.device != feat.device or t.dtype != want:
            raise ValueError(f"gather_gemm: {name} must be {want} on "
                             f"{feat.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"gather_gemm: {name} must be contiguous")
    out = torch.empty((b, vout, cout), dtype=dtype, device=feat.device)
    if b == 0 or vout == 0:
        return out
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    if dtype == torch.bfloat16:
        cuda_sparse_conv_bf16.launch(feat, slots, weight, out, stream)
        return out
    lib = _load()
    if lib.sparse_conv_smem_bytes(k, cin, cout) > MAX_SMEM_BYTES:
        raise ValueError(f"gather_gemm: K={k}, Cin={cin}, Cout={cout} needs "
                         "more than the 227 KB of shared memory of a block")
    code = lib.sparse_conv_launch(
        feat.data_ptr(), slots.data_ptr(), weight.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        b, vin, vout, k, cin, cout, stream)
    from ..csrc.build import check

    check(lib, code, "sparse_conv_launch")
    launches += 1
    return out
