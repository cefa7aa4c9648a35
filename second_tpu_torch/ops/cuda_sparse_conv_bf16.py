"""K1-bf16: K1's gather-GEMM in bf16 (``csrc/sparse_conv_bf16.cu``).

Replaces the bf16 instantiation of the Pallas TPU kernel
``second_tpu/ops/banded_sparse.py`` ``_banded_call_fused``, which the JAX
package's mixed precision runs:

    out[b, o] = bf16(sum_k f32(feat[b, slots[b, o, k]]) @ f32(W[k]))

with features and weights in bf16, sums in f32 and one rounding at the
end. :func:`second_tpu_torch.ops.cuda_sparse_conv.gather_gemm` checks
its inputs and calls :func:`launch` for bf16 CUDA tensors; its plain
version, ``gather_gemm_plain``, serves both dtypes. ``launches`` counts
this kernel's launches (one a call: the weight's arrangement and the
product), apart from K1's.

The kernel multiplies with ``wgmma`` from shared memory. Its weight
operand arrives by one bulk copy per offset from a scratch copy of the
weight laid out as the ``wgmma`` descriptor reads it
(:func:`arrange_weight` is that layout in plain torch); a block's
shared memory is :func:`smem_bytes`, a ring of :func:`stages_for`
stages. These mirror the CUDA source's arithmetic.
"""

import ctypes

import torch

KERNEL = "sparse_conv_bf16"
launches = 0

# rows of a tile (TM in the CUDA source: one consumer warpgroup of 64)
TILE_ROWS = 64
# the ring's target size, and its bounds in stages
RING_BYTES = 48 * 1024
MIN_STAGES, MAX_STAGES = 4, 8
# the block's mbarriers and per-warp offset masks
HEADER_BYTES = 256

_lib = None


def padded_widths(cin, cout):
    """(Cin, Cout) padded as the kernel pads them: powers of two, Cin to
    at least the wgmma depth 16, Cout to at least 8."""
    def pad(c, least):
        p = least
        while p < c:
            p *= 2
        return p

    return pad(cin, 16), pad(cout, 8)


def stages_for(cin_p, cout_p):
    """Stages of the gather ring for padded widths: as many as fit
    ``RING_BYTES``, within [MIN_STAGES, MAX_STAGES]."""
    stage = TILE_ROWS * cin_p * 2 + cin_p * cout_p * 2
    return min(MAX_STAGES, max(MIN_STAGES, RING_BYTES // stage))


def smem_bytes(k, cin_p, cout_p, stages=None):
    """Dynamic shared memory of a block: the header, the tile's slots
    [K, TILE_ROWS + 1] int32 (a padded row stride) rounded up to 128
    bytes, and the ring (each stage TILE_ROWS gathered rows of Cin_p bf16
    and W[k] as Cin_p x Cout_p bf16)."""
    if stages is None:
        stages = stages_for(cin_p, cout_p)
    slot_bytes = -(-k * (TILE_ROWS + 1) * 4 // 128) * 128
    return (HEADER_BYTES + slot_bytes
            + stages * (TILE_ROWS * cin_p * 2 + cin_p * cout_p * 2))


def arrange_weight(weight, cin_p, cout_p):
    """weight [K, Cin, Cout] -> [K, Cout_p / 8, Cin_p / 8, 8, 8] with
    element [k, n // 8, c // 8, n % 8, c % 8] = W[k, c, n] (zero in the
    padding): each W[k] as the kernel's ``wgmma`` B descriptor reads it,
    K-major 8 x 8 core matrices of 128 bytes. The kernel's
    ``arrange_weight_kernel`` writes the same bytes."""
    k, cin, cout = weight.shape
    w = weight.new_zeros(k, cin_p, cout_p)
    w[:, :cin, :cout] = weight
    return w.view(k, cin_p // 8, 8, cout_p // 8, 8).permute(
        0, 3, 1, 4, 2).contiguous()


def unarrange_weight(warr, cin, cout):
    """The inverse of :func:`arrange_weight`: [K, Cin, Cout]."""
    k, nb, cb = warr.shape[:3]
    w = warr.permute(0, 2, 4, 1, 3).reshape(k, cb * 8, nb * 8)
    return w[:, :cin, :cout].contiguous()


def _load():
    global _lib
    if _lib is None:
        from ..csrc import build

        lib = build.load(KERNEL)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sparse_conv_bf16_launch.argtypes = [vp] * 5 + [i] * 6 + [vp]
        lib.sparse_conv_bf16_launch.restype = i
        lib.sparse_conv_bf16_arrange.argtypes = [vp, vp, i, i, i, vp]
        lib.sparse_conv_bf16_arrange.restype = i
        lib.sparse_conv_bf16_stages.argtypes = [i, i]
        lib.sparse_conv_bf16_stages.restype = i
        lib.sparse_conv_bf16_smem_bytes.argtypes = [i, i, i]
        lib.sparse_conv_bf16_smem_bytes.restype = i
        lib.sparse_conv_bf16_blocks_per_sm.argtypes = [i, i, i]
        lib.sparse_conv_bf16_blocks_per_sm.restype = i
        _lib = lib
    return _lib


def arranged_scratch(weight):
    """The scratch the kernel arranges ``weight`` [K, Cin, Cout] into."""
    k, cin, cout = weight.shape
    cin_p, cout_p = padded_widths(cin, cout)
    return torch.empty((k, cout_p // 8, cin_p // 8, 8, 8),
                       dtype=torch.bfloat16, device=weight.device)


def arrange_on_device(weight, stream):
    """The kernel's own weight arrangement of a contiguous bf16 CUDA
    ``weight`` (for the card tests: it equals :func:`arrange_weight`)."""
    from ..csrc.build import check

    k, cin, cout = weight.shape
    warr = arranged_scratch(weight)
    lib = _load()
    code = lib.sparse_conv_bf16_arrange(weight.data_ptr(), warr.data_ptr(),
                                        k, cin, cout, stream)
    check(lib, code, "sparse_conv_bf16_arrange")
    return warr


def launch(feat, slots, weight, out, stream):
    """out [B, Vout, Cout] = the kernel on checked, contiguous bf16 CUDA
    tensors feat [B, Vin, Cin] and weight [K, Cin, Cout], int32 slots
    [B, Vout, K], on the CUDA stream handle ``stream``."""
    global launches
    from ..csrc.build import check

    b, vin, cin = feat.shape
    _, vout, k = slots.shape
    warr = arranged_scratch(weight)
    lib = _load()
    code = lib.sparse_conv_bf16_launch(
        feat.data_ptr(), slots.data_ptr(), weight.data_ptr(),
        warr.data_ptr(), out.data_ptr(), b, vin, vout, k, cin,
        weight.shape[2], stream)
    check(lib, code, "sparse_conv_bf16_launch")
    launches += 1
