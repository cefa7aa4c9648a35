"""Device ms a profiled request under the port's ``net.middle.wide``
span (the residual middle's 128-channel stage: conv4, its two blocks and
conv_out, their K1 launches, norms and residual sums), each kernel,
memcpy or memset charged to the innermost program span around its
launch (``stages.attribute``)."""


def read(run):
    s = run.get("wide_gpu_s")
    return s * 1e3 if s else None
