"""Data parallelism: a ``torch.distributed`` process group in the place of
the JAX package's device mesh (``mesh.py``), and the multi-rank dry run
(``dryrun.py``)."""

from .mesh import (
    all_gather_cat,
    all_reduce_grads,
    all_reduce_sum,
    assert_replicated,
    barrier,
    broadcast_object,
    gather_to_rank0,
    launched,
    make_mesh,
    put_sharded,
    rank,
    run_ranks,
    shard_example,
    shard_slice,
    state_digest,
    world,
)

__all__ = [
    "all_gather_cat",
    "all_reduce_grads",
    "all_reduce_sum",
    "assert_replicated",
    "barrier",
    "broadcast_object",
    "gather_to_rank0",
    "launched",
    "make_mesh",
    "put_sharded",
    "rank",
    "run_ranks",
    "shard_example",
    "shard_slice",
    "state_digest",
    "world",
]
