"""K2: sparse-conv weight gradient (``csrc/sparse_conv_dw.cu``).

Replaces the Pallas TPU kernel ``second_tpu/ops/banded_sparse.py``
``_banded_dw_call`` (reached through ``_banded_dw``):

    dW[k] = sum_{b, o} feat[b, slots[b, o, k]]^T @ dout[b, o]

over a host-built rulebook ``slots`` [B, Vout, K]; a slot outside
[0, Vin) contributes nothing. The kernel reduces in a fixed order (no
atomics), so two calls on the same inputs give bitwise-equal results.
What bounds it on the card and how it is laid out is in the CUDA
source's header.

:func:`sparse_conv_dw` launches the kernel for CUDA tensors and runs
:func:`sparse_conv_dw_plain` for CPU tensors; ``launches`` counts kernel
launches.
"""

import ctypes

import torch

from .cuda_sparse_conv import MAX_SMEM_BYTES, gather_rows, refuse_wide

KERNEL = "sparse_conv_dw"
launches = 0

# blocks of the first launch, (offset group, row split): sixteen per SM
# of an H100, so that other blocks work while one restarts on its next
# tile (fewer ran slower at car.fhd's batch-8 shapes), few enough that
# the [S, K, Cin, Cout] partials stay under ~70 MB
TARGET_BLOCKS = 16 * 132
TILE_ROWS = 64

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..csrc import build

        lib = build.load(KERNEL)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sparse_conv_dw_launch.argtypes = [
            vp, vp, vp, vp, vp, i, i, i, i, i, i, i, ctypes.c_longlong, vp]
        lib.sparse_conv_dw_launch.restype = i
        lib.sparse_conv_dw_smem_bytes.argtypes = [i, i]
        lib.sparse_conv_dw_smem_bytes.restype = i
        lib.sparse_conv_dw_groups.argtypes = [i, i, i]
        lib.sparse_conv_dw_groups.restype = i
        _lib = lib
    return _lib


def sparse_conv_dw_plain(feat, slots, dout):
    """Plain PyTorch version: gather [B*Vout, K*Cin], then one
    [K*Cin, B*Vout] @ [B*Vout, Cout] matmul."""
    b, _, cin = feat.shape
    _, vout, k = slots.shape
    cout = dout.shape[-1]
    rows = gather_rows(feat, slots).reshape(b * vout, k * cin)
    dw = rows.T @ dout.reshape(b * vout, cout)
    return dw.reshape(k, cin, cout)


def splits_for(rows, groups):
    """(splits, rows per split) of the first launch for ``rows`` = B*Vout
    rule rows and ``groups`` offset groups: whole 64-row tiles, about
    ``TARGET_BLOCKS`` blocks in all."""
    tiles = max(-(-rows // TILE_ROWS), 1)
    want = min(tiles, max(TARGET_BLOCKS // groups, 1))
    per = -(-tiles // want) * TILE_ROWS
    return max(-(-rows // per), 1), per


def sparse_conv_dw(feat, slots, dout):
    """feat [B, Vin, Cin] f32, slots [B, Vout, K] int32, dout
    [B, Vout, Cout] f32 -> dW [K, Cin, Cout] f32.

    CPU tensors take :func:`sparse_conv_dw_plain`; CUDA tensors launch
    the kernel (Cout a power of two in [4, 64], Cin <= 64) or raise.
    Cin or Cout above 64 raises on any device (no 128-wide K2 yet).
    """
    global launches
    refuse_wide("sparse_conv_dw", feat.shape[-1], dout.shape[-1])
    if feat.device.type == "cpu":
        return sparse_conv_dw_plain(feat, slots, dout)
    if feat.device.type != "cuda":
        raise ValueError(f"sparse_conv_dw: unsupported device {feat.device}")
    if feat.dim() != 3 or slots.dim() != 3 or dout.dim() != 3:
        raise ValueError("sparse_conv_dw: want feat [B,V,C], slots [B,Vo,K], "
                         "dout [B,Vo,Co]")
    b, vin, cin = feat.shape
    bs, vout, k = slots.shape
    bd, vout_d, cout = dout.shape
    if bs != b or bd != b or vout_d != vout:
        raise ValueError(
            f"sparse_conv_dw: shapes disagree: feat {tuple(feat.shape)}, "
            f"slots {tuple(slots.shape)}, dout {tuple(dout.shape)}")
    if not (1 <= cin <= 64 and 4 <= cout <= 64 and cout & (cout - 1) == 0):
        raise ValueError(f"sparse_conv_dw: kernel takes Cin <= 64 and Cout a "
                         f"power of two in [4, 64], got {cin}, {cout}")
    if b * vin >= 2 ** 31:
        raise ValueError("sparse_conv_dw: B * Vin must fit in int32")
    for name, t, dtype in (("feat", feat, torch.float32),
                           ("slots", slots, torch.int32),
                           ("dout", dout, torch.float32)):
        if t.device != feat.device or t.dtype != dtype:
            raise ValueError(f"sparse_conv_dw: {name} must be {dtype} on "
                             f"{feat.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"sparse_conv_dw: {name} must be contiguous")
    if b == 0 or vout == 0:
        return torch.zeros((k, cin, cout), dtype=torch.float32,
                           device=feat.device)
    lib = _load()
    if lib.sparse_conv_dw_smem_bytes(cin, cout) > MAX_SMEM_BYTES:
        raise ValueError(f"sparse_conv_dw: Cin={cin}, Cout={cout} needs more "
                         "than the 227 KB of shared memory of a block")
    splits, per = splits_for(b * vout, lib.sparse_conv_dw_groups(k, cin, cout))
    partial = torch.empty((splits, k, cin, cout), dtype=torch.float32,
                          device=feat.device)
    dw = torch.empty((k, cin, cout), dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    code = lib.sparse_conv_dw_launch(
        feat.data_ptr(), slots.data_ptr(), dout.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), b, vin, vout, k, cin, cout,
        splits, per, stream)
    from ..csrc.build import check

    check(lib, code, "sparse_conv_dw_launch")
    launches += 1
    return dw
