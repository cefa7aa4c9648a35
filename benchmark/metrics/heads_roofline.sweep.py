"""The heads' least time a request (``mhead_flops.heads_bound_s``: their
operations at PEAK_FLOPS or their bytes at PEAK_HBM_BYTES, whichever is
longer, from the configuration's shapes) over their device time a
profiled request under ``net.heads``, in %."""


def read(run):
    spent, bound = run.get("heads_gpu_s"), run.get("heads_bound_s")
    if not spent or not bound:
        return None
    return 100.0 * bound / spent
