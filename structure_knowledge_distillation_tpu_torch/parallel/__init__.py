"""Data parallelism over processes (the JAX package's `parallel/` `data` axis)."""

from structure_knowledge_distillation_tpu_torch.parallel.data_parallel import (
    all_reduce_sum,
    all_reduce_sum_differentiable,
    any_rank,
    backend_for,
    broadcast_state,
    gather_rows,
    host_barrier,
    host_group,
    join_group,
    launch,
    rank_device,
    shard_rows,
    world_of,
)

__all__ = [
    "all_reduce_sum",
    "all_reduce_sum_differentiable",
    "any_rank",
    "backend_for",
    "broadcast_state",
    "gather_rows",
    "host_barrier",
    "host_group",
    "join_group",
    "launch",
    "rank_device",
    "shard_rows",
    "world_of",
]
