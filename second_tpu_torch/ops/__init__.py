"""Kernel wrappers (K1 cuda_sparse_conv, K3 cuda_iou, K4 cuda_nms) and the
tensor ops around them."""


def launch_counts():
    """This process's kernel launches so far, by each wrapper's
    ``KERNEL`` name: a process that runs a path for another (a rank, a
    learning proof) reports them back with its result."""
    from . import (cuda_iou, cuda_nms, cuda_sparse_conv,
                   cuda_sparse_conv_bf16, cuda_sparse_conv_dw)

    return {m.KERNEL: m.launches for m in (
        cuda_sparse_conv, cuda_sparse_conv_dw, cuda_iou, cuda_nms,
        cuda_sparse_conv_bf16)}
