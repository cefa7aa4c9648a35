"""Data parallelism over a ``torch.distributed`` process group (twin of
``second_tpu/parallel/mesh.py``).

The JAX package runs one jitted SPMD program over a device mesh: the
batch is sharded over the ``data`` axis, the state replicated, and XLA
inserts the gradient all-reduce. Here each rank is a process (launched
by ``torchrun``, or by :func:`run_ranks`), the "mesh" is the default
process group, and the collectives are explicit: the training step
all-reduces its gradients (:func:`all_reduce_grads`), and every
statistic over the batch (``MaskedBatchNorm``'s moments, the GHM
histograms, the logged metrics) is all-reduced where it is computed, so
that each rank's step computes what JAX's sharded step computes on the
global batch. Without a group (or at world size 1) every function here
is the identity and issues no collective.
"""

import datetime
import hashlib
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# the default group's timeout: a rank that dies leaves the others
# waiting in a collective this long before they raise
TIMEOUT = datetime.timedelta(minutes=30)
# gradients are all-reduced in flat buckets of at most this many bytes
BUCKET_BYTES = 25 * 2**20


def world():
    """The group's size; 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def launched():
    """Whether this process runs as a rank: a group exists, or a launcher
    (``torchrun``) set ``WORLD_SIZE``."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def _env_int(name, value):
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(
            f"{name} is not set: launch with torchrun, or pass rank and "
            f"world_size to make_mesh")
    return int(os.environ[name])


def make_mesh(device="cuda", backend=None, init_method=None, rank=None,
              world_size=None):
    """Join the default process group (once per process) and return this
    rank's device.

    rank, world_size: from the arguments, else from ``RANK`` and
    ``WORLD_SIZE``; init_method: by default ``env://`` (``MASTER_ADDR``
    and ``MASTER_PORT``). backend: "nccl" on CUDA and "gloo" on the CPU
    by default. ``device`` "cuda" gives rank r the card ``LOCAL_RANK``
    (default: the rank); a named card ("cuda:0") is every rank's, which
    only gloo allows for more than one rank (NCCL refuses two ranks on
    one device). Raises on any other combination; nothing falls back.
    """
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if device.type == "cpu" and backend != "gloo":
        raise ValueError(f"backend {backend!r} on the CPU: use gloo")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but no CUDA device")
    if not dist.is_initialized():
        r = _env_int("RANK", rank)
        w = _env_int("WORLD_SIZE", world_size)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=r, world_size=w, timeout=TIMEOUT)
    elif dist.get_backend() != backend:
        raise ValueError(f"the group runs {dist.get_backend()}, not "
                         f"{backend}")
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {local} has no card: "
                    f"{torch.cuda.device_count()} visible")
            device = torch.device("cuda", local)
        elif dist.get_world_size() > 1 and backend != "gloo":
            raise ValueError(
                f"{dist.get_world_size()} ranks on the named card {device} "
                f"need backend gloo: NCCL refuses two ranks on one device")
        torch.cuda.set_device(device)
    return device


def shard_slice(batch_size, rank_, world_size):
    """Rank ``rank_``'s rows of a global batch of ``batch_size`` split over
    ``world_size`` ranks: the contiguous slice [r B / W, (r + 1) B / W),
    the order in which JAX's ``P("data")`` splits a batch."""
    if batch_size % world_size:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{world_size} ranks")
    n = batch_size // world_size
    return slice(rank_ * n, (rank_ + 1) * n)


def shard_example(batch_size):
    """This rank's rows (:func:`shard_slice`) of a global batch of
    ``batch_size``."""
    return shard_slice(batch_size, rank(), world())


def put_sharded(example, device):
    """This rank's slice (:func:`shard_example`) of every array of a global
    host batch, as tensors on ``device``."""
    rows = shard_example(len(next(iter(example.values()))))
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
            for k, v in example.items()}


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its backward sums the ranks' gradients, since
    every rank's loss depends on the sum."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x):
    """The sum of ``x`` over the ranks, differentiable; ``x`` itself at
    world size 1."""
    return _AllReduceSum.apply(x) if world() > 1 else x


def all_reduce_grads(grads):
    """The ranks' mean of each tensor of ``grads`` (new tensors; the list
    itself at world size 1): flattened into buckets of at most
    ``BUCKET_BYTES`` by device and dtype, all-reduced asynchronously,
    then divided by the world size (gloo has no average)."""
    w = world()
    if w == 1:
        return list(grads)
    buckets, filling = [], {}  # (device, dtype) -> [indices, bytes]
    for i, g in enumerate(grads):
        nbytes = g.numel() * g.element_size()
        bucket = filling.get((g.device, g.dtype))
        if bucket is None or bucket[1] + nbytes > BUCKET_BYTES:
            bucket = filling[(g.device, g.dtype)] = [[], 0]
            buckets.append(bucket[0])
        bucket[0].append(i)
        bucket[1] += nbytes
    pending = []
    for idx in buckets:
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        pending.append((idx, flat, dist.all_reduce(flat, async_op=True)))
    out = [None] * len(grads)
    for idx, flat, work in pending:
        work.wait()
        flat.div_(w)
        pieces = flat.split([grads[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.view_as(grads[i])
    return out


def all_gather_cat(x):
    """The ranks' ``x`` concatenated on the first axis, in rank order;
    ``x`` at world size 1."""
    if world() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def gather_to_rank0(obj):
    """Every rank's picklable ``obj``, in rank order, on rank 0 (None on
    the others); ``[obj]`` without a group."""
    if world() == 1:
        return [obj]
    out = [None] * world() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def state_digest(module):
    """sha256 of ``module``'s state dict (names and bytes): equal digests
    are bitwise equal states."""
    h = hashlib.sha256()
    for name, value in module.state_dict().items():
        h.update(name.encode())
        h.update(value.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def assert_replicated(module):
    """Raise unless every rank holds bitwise the same state dict of
    ``module`` (one all-gather of a digest): the data-parallel step keeps
    the replicas equal without a broadcast, and this checks it."""
    if world() == 1:
        return
    digests = [None] * world()
    dist.all_gather_object(digests, state_digest(module))
    if len(set(digests)) != 1:
        raise RuntimeError(f"the ranks' states differ: digests {digests}")


def barrier():
    """Wait for every rank (nothing without a group)."""
    if dist.is_initialized():
        dist.barrier()


def _math_flags():
    """The caller's choices of arithmetic for CUDA (TF32 in matmuls and
    cuDNN, cuDNN's deterministic and benchmark modes): a spawned process
    starts from torch's defaults (TF32 on in cuDNN), so the ranks take
    these over to compute as the caller does."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


def _rank_main(fn, rank_, world_size, init_method, args, results, flags):
    # the ranks of one host share its cores
    torch.set_num_threads(1)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = flags
    # the ranks of one host meet on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        results.put((rank_, True, fn(rank_, world_size, init_method, *args)))
    except BaseException:
        results.put((rank_, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size, args=(), timeout=900.0):
    """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size``
    spawned processes of this host and return their results in rank
    order. ``fn`` (importable by module path, as every target of a
    spawned process) joins the group with ``make_mesh(...,
    init_method=init_method, rank=rank, world_size=world_size)`` and
    returns something picklable (numpy, not tensors). Each child runs
    one torch thread and this process's TF32 and cuDNN settings. Raises with the rank's traceback when a
    rank fails, and RuntimeError when a rank dies without a word or the
    ranks outlast ``timeout`` seconds; no rank outlives the call."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rendezvous_")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world_size, init_method, args, results, _math_flags()))
        for r in range(world_size)]
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code "
                                       f"{dead[0]} before its result")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{world_size} ranks outlasted {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world_size} failed:\n"
                                   f"{value}")
            out[r] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10.0)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
