"""K3: pairwise rotated IoU (``csrc/rotated_iou.cu``).

Replaces the Pallas TPU kernel ``second_tpu/ops/pallas_iou.py``
``rotated_iou_matrix_pallas``: [N, 5] x [M, 5] (x, y, w, l, angle) ->
[N, M] IoU by Liang-Barsky edge clipping plus Green's theorem, with the
parallel-edge rules of ``second_tpu.core.rotated_iou``. Each pair is
computed in a frame centred on its first box, which keeps fp32 accurate
far from the sensor (see the CUDA source's header, which also says
what bounds the kernel on the card). The kernel writes 0.0 without
clipping for the pairs :func:`far_pairs` rejects, and clips the rest.

:func:`rotated_iou_matrix` launches the kernel for CUDA tensors and runs
:func:`rotated_iou_matrix_plain` for CPU tensors; ``launches`` counts
kernel launches.
"""

import ctypes

import torch

KERNEL = "rotated_iou"
# exact-zero tests of the boundary rules need unfused multiply-adds, and
# the kernel's far-pair test must round as :func:`far_pairs` does
BUILD_FLAGS = ("-fmad=false",)
# the kernel's far-pair reject (``far_pair`` in the CUDA source): the
# circumcircles grown by FAR_SCALE are apart, and both boxes have sides
# of at least SIZE_MIN (a box of zero size has only trivial half-planes
# and scores the other box's area wherever it lies). Both are powers of
# two apart from 1, so float32 holds them exactly on both sides.
FAR_SCALE = 1.0 + 2.0 ** -10
SIZE_MIN = 2.0 ** -10
launches = 0

_lib = None

# corner template in ring order (clockwise), as core.rotated_iou
_DX = (-0.5, -0.5, 0.5, 0.5)
_DY = (-0.5, 0.5, 0.5, -0.5)


def _load():
    global _lib
    if _lib is None:
        from ..csrc import build

        lib = build.load(KERNEL, BUILD_FLAGS)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.rotated_iou_launch.argtypes = [vp, vp, vp, i, i, vp]
        lib.rotated_iou_launch.restype = i
        _lib = lib
    return _lib


def _geometry(boxes):
    """[N, 5] -> the boxes in their own frames: centre-relative corners
    (cx, cy) and outward half-planes (nx, ny, d), each a list of four
    [N] tensors, and the area [N]."""
    _, _, w, l, r = boxes.unbind(-1)
    c, s = torch.cos(r), torch.sin(r)
    cx, cy = [], []
    for k in range(4):
        dx = _DX[k] * w
        dy = _DY[k] * l
        cx.append(dx * c + dy * s)
        cy.append(-dx * s + dy * c)
    planes = []
    for k in range(4):
        k2 = (k + 1) % 4
        nx = -(cy[k2] - cy[k])
        ny = cx[k2] - cx[k]
        flip = nx * -cx[k] + ny * -cy[k] > 0  # point at the centre
        nx = torch.where(flip, -nx, nx)
        ny = torch.where(flip, -ny, ny)
        planes.append((nx, ny, nx * cx[k] + ny * cy[k]))
    return cx, cy, planes, w * l


def _edge_contrib(cx, cy, planes, keep_boundary):
    """Sum over the subject's edges of cross(P, Q) of each edge clipped
    to the clip box's half-planes; all arguments broadcast to [N, M]."""
    total = 0.0
    for k in range(4):
        k2 = (k + 1) % 4
        px, py = cx[k], cy[k]
        rx, ry = cx[k2] - px, cy[k2] - py
        t0 = torch.zeros_like(px)
        t1 = torch.ones_like(px)
        par_out = torch.zeros_like(px, dtype=torch.bool)
        for nx, ny, d in planes:
            denom = rx * nx + ry * ny
            numer = d - (px * nx + py * ny)
            t_of = numer / torch.where(denom == 0, torch.ones_like(denom),
                                       denom)
            t1 = torch.minimum(
                t1, torch.where(denom > 0, t_of, torch.full_like(t_of, 1e30)))
            t0 = torch.maximum(
                t0, torch.where(denom < 0, t_of, torch.full_like(t_of, -1e30)))
            out = (denom == 0) & (numer < 0)
            if not keep_boundary:
                same_dir = (rx * ny - ry * nx) > 0
                out = out | ((denom == 0) & (numer == 0) & same_dir)
            par_out = par_out | out
        ok = (t0 <= t1) & ~par_out
        cross = (px + t0 * rx) * (py + t1 * ry) - (py + t0 * ry) * (px + t1 * rx)
        total = total + torch.where(ok, cross, torch.zeros_like(cross))
    return total


def rotated_iou_matrix_plain(boxes1, boxes2):
    """Plain PyTorch version, same arithmetic as the kernel, each pair in
    a frame centred on its first box (works in float32 or float64)."""
    acx, acy, aplanes, aarea = _geometry(boxes1)
    bcx, bcy, bplanes, barea = _geometry(boxes2)
    ox = boxes2[None, :, 0] - boxes1[:, None, 0]  # [N, M] shift of box b
    oy = boxes2[None, :, 1] - boxes1[:, None, 1]
    a_cx = [v[:, None] for v in acx]
    a_cy = [v[:, None] for v in acy]
    a_planes = [tuple(v[:, None] for v in p) for p in aplanes]
    b_cx = [v[None, :] + ox for v in bcx]
    b_cy = [v[None, :] + oy for v in bcy]
    b_planes = [(nx[None, :], ny[None, :], d[None, :] + (nx[None, :] * ox
                                                          + ny[None, :] * oy))
                for nx, ny, d in bplanes]
    s = _edge_contrib(a_cx, a_cy, b_planes, keep_boundary=True)
    s = s + _edge_contrib(b_cx, b_cy, a_planes, keep_boundary=False)
    inter = 0.5 * torch.abs(s)
    union = aarea[:, None] + barea[None, :] - inter
    return inter / torch.where(union <= 0, torch.ones_like(union), union)


def _reach(boxes):
    """[N, 5] -> circumradius [N] and whether both sides reach SIZE_MIN."""
    _, _, w, l, _ = boxes.unbind(-1)
    return 0.5 * torch.sqrt(w * w + l * l), (w >= SIZE_MIN) & (l >= SIZE_MIN)


def far_pairs(boxes1, boxes2):
    """[N, 5] x [M, 5] -> [N, M] bool: the pairs the kernel rejects and
    writes as 0.0 without clipping, in the kernel's arithmetic (line for
    line its ``far_pair``). Such boxes cannot intersect, and in float32
    :func:`rotated_iou_matrix_plain` is exactly 0.0 on each of them
    (``tests/test_torch_kernels.py``)."""
    r1, sized1 = _reach(boxes1)
    r2, sized2 = _reach(boxes2)
    dx = boxes2[None, :, 0] - boxes1[:, None, 0]
    dy = boxes2[None, :, 1] - boxes1[:, None, 1]
    reach = (r1[:, None] + r2[None, :]) * FAR_SCALE
    return (sized1[:, None] & sized2[None, :]
            & (dx * dx + dy * dy > reach * reach))


def rotated_iou_matrix(boxes1, boxes2):
    """[N, 5] x [M, 5] f32 -> [N, M] rotated IoU.

    CPU tensors take :func:`rotated_iou_matrix_plain`; CUDA tensors
    launch the kernel or raise.
    """
    global launches
    if boxes1.device.type == "cpu":
        return rotated_iou_matrix_plain(boxes1, boxes2)
    if boxes1.device.type != "cuda":
        raise ValueError(f"rotated_iou_matrix: unsupported device "
                         f"{boxes1.device}")
    for name, t in (("boxes1", boxes1), ("boxes2", boxes2)):
        if t.dim() != 2 or t.shape[1] != 5:
            raise ValueError(f"rotated_iou_matrix: {name} must be [N, 5], "
                             f"got {tuple(t.shape)}")
        if t.device != boxes1.device or t.dtype != torch.float32:
            raise ValueError(f"rotated_iou_matrix: {name} must be float32 "
                             f"on {boxes1.device}")
        if not t.is_contiguous():
            raise ValueError(f"rotated_iou_matrix: {name} must be contiguous")
    n, m = boxes1.shape[0], boxes2.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=boxes1.device)
    if n == 0 or m == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(boxes1.device).cuda_stream
    code = lib.rotated_iou_launch(boxes1.data_ptr(), boxes2.data_ptr(),
                                  out.data_ptr(), n, m, stream)
    from ..csrc.build import check

    check(lib, code, "rotated_iou_launch")
    launches += 1
    return out
