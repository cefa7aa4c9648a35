"""What bounds K1 (``csrc/sparse_conv.cu``), K2
(``csrc/sparse_conv_dw.cu``) and K1-bf16 (``csrc/sparse_conv_bf16.cu``)
on the card: each kernel as built beside copies of its source with one
part taken out, timed on car.fhd's rulebooks.

    python -m second_tpu_torch.tools.kernel_variants [--kernels NAME ...]

Variants (text substitutions of the source, built with the same nvcc
flags into ``csrc/build/variants/``):

* ``as built``;
* ``no products``: the MMAs removed (K1-bf16: the ``wgmma`` issue), so
  the compiler drops the fragment loads and splits as well: what is
  left is the slot staging, the skips and the cp.async gathers (K1-bf16:
  and its ring, the weights' bulk copies and the consumers' waits);
* ``one TF32 pass`` (K1, K2): a_hi*b_hi only, one MMA instead of three
  and no lo parts (wrong at K1's 1e-4; timed only to weigh the
  tensor-core work);
* ``one producer warp`` (K1-bf16): the gathers issued by one warp
  instead of a warpgroup;
* ``two consumer warpgroups`` (K1-bf16): 128-row tiles, two consumer
  warpgroups a block sharing each stage's W[k], instead of 64-row tiles
  and one;
* ``ring x2`` (K1-bf16): the gather ring's target size doubled (more
  stages, fewer blocks an SM);
* ``no reads`` (K1-bf16, full 16-byte rows): every row a miss, so the
  cp.async zero-fill and read nothing: the ring without memory latency;
* ``rows via L1`` (K1-bf16): the 16-byte row copies cached in L1
  (cp.async.ca), for the rows a tile reads at several offsets;
* ``no weight copy`` (K1-bf16): W[k]'s bulk copies left out;
* ``no proxy fence`` (K1-bf16): the consumers' cross-proxy fence after
  each full barrier left out;
* ``slots only`` (K1-bf16): no offset runs, only each tile's slot
  staging and offset mask (and the zeros of tiles with no hit);
* ``no zeros`` (K1-bf16): tiles with no hit left unwritten;
* ``launch only`` (K1-bf16): every block returns at once (the weight
  arrangement and the launch of the grid);
* ``no arrangement`` (K1-bf16): the weight arrangement kernel launched
  but arranging nothing.

For K1-bf16 it also prints the blocks resident on an SM at each shape
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).

Shapes: the subm 64->64, subm 32->32 and strided 16->32 convs (car.fhd's
subm6_w, subm3_w and down2_w) of one ``make_kitti_scene`` frame at
inference capacity (batch 1) and, for K1 and K2, of a batch of 8 at the
train capacity, as ``chip_smoke.py`` builds them. K1 and K2: CUDA-event
means of 10 calls after 2 warm-up calls; K1-bf16, whose calls are short
beside their host work: device-only, 20 calls captured in a CUDA graph
(``chip_smoke.py``'s ``graph_ms``). Prints each K1-bf16
instantiation's registers, shared memory and spills (``nvcc -Xptxas
-v``). Needs a CUDA card; prints the card's name and power limit first.
"""

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..builders.dataset_builder import build_prep_func
from ..builders.network_builder import build_network
from ..configs import load_pipeline_config, schema
from ..csrc import build
from ..data import make_kitti_scene, merge_second_batch
from ..models.voxelnet import init_weights
from ..ops import cuda_sparse_conv, cuda_sparse_conv_bf16, cuda_sparse_conv_dw

CONFIG = "configs/car.fhd.config"
K1_MMA = "mma_3xtf32(part[j], a_hi, a_lo, b_hi, b_lo);"
K2_MMA = "mma_3xtf32(tile, d_hi, d_lo, a_hi[ks], a_lo[ks]);"
K1B_MMA = ("Wgmma<COUT_P>::run(part, da + j * kDescK16, db + j * kDescK16, "
           "j > 0);")
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
    "sparse_conv_bf16": {
        "as built": [],
        "no products": [(K1B_MMA, "")],
        "one producer warp": [("constexpr int PRODUCER_WARPS = 4;",
                               "constexpr int PRODUCER_WARPS = 1;")],
        "ring x2": [("constexpr int RING_BYTES = 48 * 1024;",
                     "constexpr int RING_BYTES = 96 * 1024;")],
        "no reads": [("row[j] = slot_k[soff[j]];", "row[j] = -1;")],
        "rows via L1": [("constexpr bool ROWS_VIA_L1 = false;",
                         "constexpr bool ROWS_VIA_L1 = true;")],
        "no weight copy": [
            ("mbar_arrive_expect_tx(&full[s], B_BYTES);",
             "mbar_arrive(&full[s]);"),
            ("bulk_copy(a_s + A_BYTES,",
             "if (false) bulk_copy(a_s + A_BYTES,")],
        "no proxy fence": [("fence_proxy_async();  // the stage's", "//")],
        "slots only": [("const int n_active = __popcll(mask);",
                        "const int n_active = 0;")],
        "no zeros": [("for (int i = tid; i < rows * cout; i += THREADS) "
                      "out_t[i] = zero;", "")],
        "launch only": [("  const int b = blockIdx.y;\n",
                         "  if (vin >= 0) return;\n  const int b = "
                         "blockIdx.y;\n")],
        "two consumer warpgroups": [("constexpr int CONSUMER_WGS = 1;",
                                     "constexpr int CONSUMER_WGS = 2;")],
        "no arrangement": [("i < total;\n       i += gridDim.x",
                            "i < 0;\n       i += gridDim.x")],
    },
}
# K1-bf16 runs on the inference paths only (bf16 training of a sparse
# middle raises)
INFERENCE_ONLY = ("sparse_conv_bf16",)
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
    return kernel, label, lib, proc.stdout + proc.stderr


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
    elif kernel == "sparse_conv_bf16":
        cout = w.shape[2]
        out = torch.empty(b, vout, cout, dtype=torch.bfloat16,
                          device=feat.device)
        warr = cuda_sparse_conv_bf16.arranged_scratch(w)
        code = lib.sparse_conv_bf16_launch(
            vp(feat.data_ptr()), vp(slots.data_ptr()), vp(w.data_ptr()),
            vp(warr.data_ptr()), vp(out.data_ptr()), b, vin, vout, k, cin,
            cout, stream)
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


def graph_ms(fn, iters=20, replays=5):
    """Device-only ms of one call of ``fn``: ``iters`` calls captured in
    a CUDA graph, replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def rulebooks(device):
    """(label, batch, example) of one inference frame and one batch of 8
    training frames, as ``chip_smoke.py`` prepares them (both with the
    loaders' host plan: a request ships none)."""
    cfg = load_pipeline_config(CONFIG)
    # the GT-database sampler is not ported (build_prep_func raises)
    cfg.train_input_reader.preprocess.database_sampler = (
        schema.Sampler.from_raw({}))
    parts = build_network(cfg, device)
    init_weights(parts["net"], torch.Generator().manual_seed(0))
    frame = merge_second_batch([build_prep_func(
        cfg.eval_input_reader, parts, training=False)(input_dict={
            "lidar": {"points": make_kitti_scene(
                np.random.RandomState(0))[0]},
            "metadata": {"image_idx": 0}})])
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", nargs="+", choices=sorted(VARIANTS),
                        default=sorted(VARIANTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    jobs = [(kernel, label, subs) for kernel in args.kernels
            for label, subs in VARIANTS[kernel].items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda job: compile_variant(*job), jobs))
    for kernel, label, _, log in libs:
        if kernel in INFERENCE_ONLY and label == "as built":
            for line in log.splitlines():
                if "Used" in line or "spill" in line or "entry" in line:
                    print(f"{kernel} ptxas: {line.strip()}", flush=True)
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
            feat16, w16 = feat.bfloat16(), w.bfloat16()
            plain = cuda_sparse_conv.gather_gemm_plain
            refs = {
                "sparse_conv": lambda: plain(feat, slots, w),
                "sparse_conv_dw": lambda: (
                    cuda_sparse_conv_dw.sparse_conv_dw_plain(
                        feat, slots, dout)),
                "sparse_conv_bf16": lambda: plain(feat16, slots,
                                                  w16).float()}
            done = {}
            for kernel, label, lib, _ in libs:
                if kernel in INFERENCE_ONLY and label == "as built" and (
                        path == "inference"):
                    per_sm = lib.sparse_conv_bf16_blocks_per_sm(27, cin,
                                                                cout)
                    print(f"{pname} {cin}->{cout} {kernel}: {per_sm} "
                          "blocks an SM", flush=True)
            for kernel, label, lib, _ in libs:
                if kernel in INFERENCE_ONLY and path != "inference":
                    continue
                bf16 = kernel == "sparse_conv_bf16"
                x, wk = (feat16, w16) if bf16 else (feat, w)

                def call():
                    return run(kernel, lib, x, slots, wk, dout)

                if kernel not in done:
                    done[kernel] = refs[kernel]()
                ref = done[kernel]
                out = call().float()
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                ms = graph_ms(call) if bf16 else cuda_ms(call)
                print(f"{path} batch {b} {pname} {cin}->{cout} {kernel} "
                      f"{label}: {ms:.4f} ms{' device-only' if bf16 else ''}"
                      f" (max err {err:.2e} of the largest magnitude)",
                      flush=True)
            del feat, dout, feat16, done
    return 0


if __name__ == "__main__":
    sys.exit(main())
