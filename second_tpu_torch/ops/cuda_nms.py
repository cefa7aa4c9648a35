"""K4: greedy NMS suppression sweep (``csrc/greedy_nms.cu``).

Replaces the Pallas TPU kernel ``second_tpu/ops/pallas_nms.py``
``greedy_suppress_pallas``: given the [n, n] IoU matrix of the
candidates in score order and their validity, visit them in rank order;
a candidate still alive is kept and kills every later candidate whose
IoU with it is above the threshold. What bounds the kernel on the card
and how it is laid out (a parallel build of [ceil(n/64), n] suppression
bitmasks, then a sweep in one warp) is in the CUDA source's header.

:func:`greedy_suppress` launches the two kernels for CUDA tensors and
runs :func:`greedy_suppress_plain` for CPU tensors; ``launches`` counts
kernel launches (two per call).
"""

import ctypes

import torch

KERNEL = "greedy_nms"
# bounds the mask workspace, (n + 1) * ceil(n / 64) * 8 bytes: 302 MB here
MAX_N = 49152
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from ..csrc import build

        lib = build.load(KERNEL)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.greedy_nms_launch.argtypes = [vp, vp, vp, vp, i, ctypes.c_float,
                                          vp]
        lib.greedy_nms_launch.restype = i
        _lib = lib
    return _lib


def greedy_suppress_plain(iou, valid, iou_threshold):
    """Plain PyTorch version: the JAX package's ``fori_loop`` sweep
    (``second_tpu/ops/nms.py`` ``_greedy_suppress``), one step per
    candidate, with no host synchronisation."""
    n = iou.shape[0]
    suppress = iou > iou_threshold
    alive = valid.clone()
    keep = torch.zeros_like(valid)
    for i in range(n):
        take = alive[i]
        keep[i] = take
        alive = alive & ~(take & suppress[i])
        alive[i] = False
    return keep


def greedy_suppress(iou, valid, iou_threshold):
    """iou [n, n] f32 in score order, valid [n] bool -> keep [n] bool.

    CPU tensors take :func:`greedy_suppress_plain`; CUDA tensors launch
    the kernel or raise.
    """
    global launches
    if iou.device.type == "cpu":
        return greedy_suppress_plain(iou, valid, iou_threshold)
    if iou.device.type != "cuda":
        raise ValueError(f"greedy_suppress: unsupported device {iou.device}")
    n = iou.shape[0]
    if iou.shape != (n, n) or valid.shape != (n,):
        raise ValueError(f"greedy_suppress: want iou [n, n] and valid [n], "
                         f"got {tuple(iou.shape)}, {tuple(valid.shape)}")
    if iou.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("greedy_suppress: iou must be float32, valid bool")
    if valid.device != iou.device:
        raise ValueError("greedy_suppress: iou and valid on different devices")
    if not (iou.is_contiguous() and valid.is_contiguous()):
        raise ValueError("greedy_suppress: inputs must be contiguous")
    if n > MAX_N:
        raise ValueError(f"greedy_suppress: n={n} > {MAX_N}")
    keep = torch.empty((n,), dtype=torch.bool, device=iou.device)
    if n == 0:
        return keep
    # suppression bitmasks, word-major: bit b of mask[w, i] is
    # j = 64 w + b > i with iou[i, j] > threshold (words left of the
    # diagonal stay unwritten); mask[w, n] is ~valid, the sweep's start
    mask = torch.empty(((n + 63) // 64, n + 1), dtype=torch.int64,
                       device=iou.device)
    lib = _load()
    stream = torch.cuda.current_stream(iou.device).cuda_stream
    code = lib.greedy_nms_launch(iou.data_ptr(), valid.data_ptr(),
                                 keep.data_ptr(), mask.data_ptr(), n,
                                 float(iou_threshold), stream)
    from ..csrc.build import check

    check(lib, code, "greedy_nms_launch")
    launches += 2
    return keep
