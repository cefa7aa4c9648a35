"""K1's least time (flops.conv_bound_s of each of the middle's K1 convs,
from the reference's rulebooks) summed over the profiled sweeps, over
K1's kernel time in the profiled window."""

K1_KERNEL = "sparse_conv_kernel"


def read(run):
    tr, bound = run.get("trace"), run.get("k1_bound_s")
    if not tr or not bound:
        return None
    spent = sum(s for name, s in tr["kernels"].items() if K1_KERNEL in name)
    return 100.0 * bound / spent if spent > 0 else None
