"""Device ms a profiled request under the port's ``net.heads`` span
(the multi-head network's crop, both heads and their concatenation),
each kernel, memcpy or memset charged to the innermost program span
around its launch (``stages.attribute``)."""


def read(run):
    s = run.get("heads_gpu_s")
    return s * 1e3 if s else None
