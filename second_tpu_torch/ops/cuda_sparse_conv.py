"""K1: gather-GEMM sparse convolution (``csrc/sparse_conv.cu``).

Replaces the Pallas TPU kernel ``second_tpu/ops/banded_sparse.py``
``_banded_call_fused``. Both submanifold and strided convs are

    out[b, o] = bias + sum_k feat[b, slots[b, o, k]] @ W[k]

over a host-built rulebook ``slots`` [B, Vout, K]; a slot outside
[0, Vin) (the planner writes Vin) reads a zero row. What bounds the
kernel on the card and how it is laid out is in the CUDA source's
header.

:func:`gather_gemm` launches the kernel for CUDA tensors and runs
:func:`gather_gemm_plain` for CPU tensors; ``launches`` counts kernel
launches.
"""

import ctypes

import torch

KERNEL = "sparse_conv"
launches = 0

# a tile's offsets with a hit are one 64-bit mask in the kernel
MAX_OFFSETS = 64
# shared memory a block can opt in to on Hopper (232 448 bytes)
MAX_SMEM_BYTES = 227 * 1024

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


def gather_gemm_plain(feat, slots, weight, bias=None):
    """Plain PyTorch version: gather [B, Vout, K*Cin] then one
    [K*Cin, Cout] matmul (the JAX package's ``ops.sparse`` formulation)."""
    k, cin, cout = weight.shape
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
    [K, Cin, Cout] f32, bias [Cout] or None -> [B, Vout, Cout] f32.

    CPU tensors take :func:`gather_gemm_plain`; CUDA tensors launch the
    kernel (Cin <= 64, Cout a power of two in [4, 64], K <= 64) or raise.
    """
    global launches
    if feat.device.type == "cpu":
        return gather_gemm_plain(feat, slots, weight, bias)
    if feat.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {feat.device}")
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
    if not (1 <= cin <= 64 and 4 <= cout <= 64 and cout & (cout - 1) == 0):
        raise ValueError(f"gather_gemm: kernel takes Cin <= 64 and Cout a "
                         f"power of two in [4, 64], got {cin}, {cout}")
    if k > MAX_OFFSETS:
        raise ValueError(f"gather_gemm: kernel takes K <= {MAX_OFFSETS} "
                         f"offsets, got {k}")
    tensors = [("feat", feat, torch.float32), ("slots", slots, torch.int32),
               ("weight", weight, torch.float32)]
    if bias is not None:
        tensors.append(("bias", bias, torch.float32))
        if bias.shape != (cout,):
            raise ValueError(f"gather_gemm: bias shape {tuple(bias.shape)}")
    for name, t, dtype in tensors:
        if t.device != feat.device or t.dtype != dtype:
            raise ValueError(f"gather_gemm: {name} must be {dtype} on "
                             f"{feat.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"gather_gemm: {name} must be contiguous")
    out = torch.empty((b, vout, cout), dtype=torch.float32, device=feat.device)
    if b == 0 or vout == 0:
        return out
    lib = _load()
    if lib.sparse_conv_smem_bytes(k, cin, cout) > MAX_SMEM_BYTES:
        raise ValueError(f"gather_gemm: K={k}, Cin={cin}, Cout={cout} needs "
                         "more than the 227 KB of shared memory of a block")
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    code = lib.sparse_conv_launch(
        feat.data_ptr(), slots.data_ptr(), weight.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        b, vin, vout, k, cin, cout, stream)
    from ..csrc.build import check

    check(lib, code, "sparse_conv_launch")
    launches += 1
    return out
