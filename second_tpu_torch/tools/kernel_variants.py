"""What bounds K1 (``csrc/sparse_conv.cu``) and K2
(``csrc/sparse_conv_dw.cu``) on the card: each kernel as built beside
copies of its source with one part taken out, timed on car.fhd's
rulebooks.

    python -m second_tpu_torch.tools.kernel_variants

Variants (text substitutions of the source, built with the same nvcc
flags into ``csrc/build/variants/``):

* ``as built``;
* ``no products``: the MMAs removed, so the compiler drops the fragment
  loads and splits as well: what is left is the slot staging, the skips
  and the cp.async gathers;
* ``one TF32 pass``: a_hi*b_hi only, one MMA instead of three and no lo
  parts (wrong at K1's 1e-4; timed only to weigh the tensor-core work).

Shapes: the subm 64->64, subm 32->32 and strided 16->32 convs of one
``make_kitti_scene`` frame at inference capacity (batch 1) and of a
batch of 8 at the train capacity, as ``chip_smoke.py`` builds them.
Times are CUDA-event means of 10 calls after 2 warm-up calls. Needs a
CUDA card; prints the card's name and power limit first.
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..builders.dataset_builder import build_prep_func
from ..builders.network_builder import build_network
from ..configs import load_pipeline_config
from ..core.inference import InferenceContext
from ..csrc import build
from ..data import make_kitti_scene, merge_second_batch
from ..models.voxelnet import init_weights
from ..ops import cuda_sparse_conv, cuda_sparse_conv_dw

CONFIG = "configs/car.fhd.config"
K1_MMA = "mma_3xtf32(part[j], a_hi, a_lo, b_hi, b_lo);"
K2_MMA = "mma_3xtf32(tile, d_hi, d_lo, a_hi[ks], a_lo[ks]);"
VARIANTS = {
    "sparse_conv": {
        "as built": [],
        "no products": [(K1_MMA, "")],
        "one TF32 pass": [(K1_MMA, "mma_tf32(part[j], a_hi, b_hi);")],
    },
    "sparse_conv_dw": {
        "as built": [],
        "no products": [(K2_MMA, "")],
        "one TF32 pass": [(K2_MMA, "mma_tf32(tile, d_hi, a_hi[ks]);")],
    },
}
# (rulebook, Cin, Cout)
CONVS = [("plan_subm2", 64, 64), ("plan_subm1", 32, 32),
         ("plan_conv0", 16, 32)]


def compile_variant(kernel, label, subs):
    """Build a copy of ``csrc/<kernel>.cu`` with ``subs`` applied; returns
    the loaded library."""
    src = (build.CSRC / f"{kernel}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{kernel} {label}: {old!r} not in the source")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{kernel}_{label.replace(' ', '_')}"
    # beside the sources, so that the quoted include resolves
    cu = build.CSRC / f"variant_{tag}.cu"
    cu.write_text(src)
    try:
        cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.BASE_FLAGS,
               str(cu), "-o", str(out / f"lib{tag}.so")]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    finally:
        cu.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out / f"lib{tag}.so"))
    return kernel, label, lib


def run(kernel, lib, feat, slots, w, dout):
    """One launch of a variant through its C entry point."""
    b, vin, cin = feat.shape
    _, vout, k = slots.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    vp = ctypes.c_void_p
    if kernel == "sparse_conv":
        cout = w.shape[2]
        out = torch.empty(b, vout, cout, device=feat.device)
        code = lib.sparse_conv_launch(
            vp(feat.data_ptr()), vp(slots.data_ptr()), vp(w.data_ptr()),
            None, vp(out.data_ptr()), b, vin, vout, k, cin, cout, stream)
    else:
        cout = dout.shape[2]
        lib.sparse_conv_dw_groups.argtypes = [ctypes.c_int] * 3
        splits, per = cuda_sparse_conv_dw.splits_for(
            b * vout, lib.sparse_conv_dw_groups(k, cin, cout))
        partial = torch.empty(splits, k, cin, cout, device=feat.device)
        out = torch.empty(k, cin, cout, device=feat.device)
        code = lib.sparse_conv_dw_launch(
            vp(feat.data_ptr()), vp(slots.data_ptr()), vp(dout.data_ptr()),
            vp(partial.data_ptr()), vp(out.data_ptr()), b, vin, vout, k,
            cin, cout, splits, ctypes.c_longlong(per), stream)
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA error {code}")
    return out


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rulebooks(device):
    """(label, batch, example) of one inference frame and one batch of 8
    training frames, as ``chip_smoke.py`` prepares them."""
    ctx = InferenceContext()
    ctx.build(CONFIG, device=device)
    frame = ctx.get_inference_input_dict(
        {}, make_kitti_scene(np.random.RandomState(0))[0])
    cfg = load_pipeline_config(CONFIG)
    parts = build_network(cfg, device)
    init_weights(parts["net"], torch.Generator().manual_seed(0))
    prep = build_prep_func(cfg.train_input_reader, parts, training=True)
    np.random.seed(0)
    frames = []
    for i in range(8):
        points, boxes, names = make_kitti_scene(np.random.RandomState(i))
        frames.append(prep(input_dict={"lidar": {
            "points": points,
            "annotations": {"boxes": boxes, "names": names}}}))
    return [("inference", 1, frame),
            ("train", 8, merge_second_batch(frames))]


def input_rows(example):
    """Input rows of each rulebook: scale i's capacity."""
    rows = {"plan_subm0": example["voxels"].shape[1]}
    for i in range(3):
        rows[f"plan_conv{i}"] = rows[f"plan_subm{i}"]
        if i < 2:
            rows[f"plan_subm{i + 1}"] = example[f"plan_conv{i}"].shape[1]
    return rows


def main():
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    jobs = [(kernel, label, subs) for kernel, variants in VARIANTS.items()
            for label, subs in variants.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda job: compile_variant(*job), jobs))
    device = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    for path, b, example in rulebooks(device):
        rows = input_rows(example)
        for pname, cin, cout in CONVS:
            slots = torch.from_numpy(example[pname].astype(np.int32)).to(device)
            vin, vout = rows[pname], slots.shape[1]
            feat = torch.randn(b, vin, cin, generator=g).to(device)
            w = (torch.randn(27, cin, cout, generator=g)
                 * (27 * cin) ** -0.5).to(device)
            dout = torch.randn(b, vout, cout, generator=g).to(device)
            refs = {"sparse_conv": cuda_sparse_conv.gather_gemm_plain(
                        feat, slots, w),
                    "sparse_conv_dw": cuda_sparse_conv_dw.sparse_conv_dw_plain(
                        feat, slots, dout)}
            for kernel, label, lib in libs:
                ref = refs[kernel]
                out = run(kernel, lib, feat, slots, w, dout)
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                ms = cuda_ms(lambda: run(kernel, lib, feat, slots, w, dout))
                print(f"{path} batch {b} {pname} {cin}->{cout} {kernel} "
                      f"{label}: {ms:.4f} ms (max err {err:.2e} of the "
                      f"largest magnitude)", flush=True)
            del feat, dout, refs
    return 0


if __name__ == "__main__":
    sys.exit(main())
