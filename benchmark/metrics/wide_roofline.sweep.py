"""The 128-channel sparse convs' least time (``res8x_flops``: each
conv's operations at PEAK_FLOPS or its bytes at PEAK_HBM_BYTES,
whichever is longer, from the reference's rulebooks) summed over the
profiled requests, over the device time of K1's launches with 128
output columns (``sparse_conv_kernel<CIN_P, 128>``) in the profiled
window, in %."""

import re

WIDE_K1 = re.compile(r"sparse_conv_kernel<\s*\d+\s*,\s*128\s*>")


def read(run):
    tr, bound = run.get("trace"), run.get("wide_bound_s")
    if not tr or not bound:
        return None
    spent = sum(s for name, s in tr["kernels"].items()
                if WIDE_K1.search(name))
    return 100.0 * bound / spent if spent > 0 else None
