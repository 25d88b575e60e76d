"""Data parallelism over processes: one rank per card, the global batch split
in contiguous slices.

Counterpart of the `data` axis of `structure_knowledge_distillation_tpu/
parallel/mesh.py`. There, jitting the step with the batch sharded on `data`
turns every full-batch reduction (BN statistics, loss means, gradient sums)
into an XLA collective. Here each rank runs the step on its slice, and the
code issues those reductions itself (the reference's `DataParallelModel` and
queue-based `InPlaceABNSync`, SURVEY §2 C10/C14):

  * a process group over N ranks: NCCL on the card, one rank per `cuda:r`,
    gloo on the CPU. Ranks meet through a `FileStore` in a temporary
    directory (`launch`), or through the launcher's environment when
    `WORLD_SIZE` is set, as under `torchrun` (`join_group`). A world of one
    is a valid group;
  * `launch` spawns the ranks and hands back each rank's return value; a
    rank that raises or dies fails the launch, and the other ranks are
    stopped;
  * the helpers the port needs, built on `all_reduce` and `broadcast` only
    (gloo has no `all_gather` for CUDA tensors): `all_reduce_sum` through one
    flat buffer, `all_reduce_sum_differentiable` (its backward is again an
    all-reduce, the semantics of `torch.distributed.nn.functional.
    all_reduce`, which torch deprecates), `gather_rows` as the all-reduce of
    a zero-filled (world, …) buffer, `broadcast_state` from rank 0,
    `shard_rows` (a rank's contiguous slice), and `any_rank` and
    `host_barrier` on a gloo group of host values (`host_group`), so a
    preemption flag or a barrier never waits on the card.

The `model`, `dcn` and `spatial` axes of the JAX mesh stay ROADMAP "Not
ported". `all_reduce_sum.calls` and `.bytes` count the device collectives
the helpers issue (as the kernel wrappers count launches: a CUDA graph
counts its collectives once, at capture).
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

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

ProcessGroup = dist.ProcessGroup
_TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device) -> str:
    """The collective backend of a device type: NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world_of(group: Optional[ProcessGroup]) -> tuple[int, int]:
    """(rank, world size) in `group`; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def rank_device(device, group: Optional[ProcessGroup]) -> torch.device:
    """The device of this rank: `cuda:<local rank>` for a CUDA device in an
    NCCL group (the launcher's `LOCAL_RANK`, else the rank: one host), the
    device as given otherwise (the CPU, or gloo ranks sharing a card)."""
    device = torch.device(device)
    if group is None or device.type != "cuda" or dist.get_backend(group) != "nccl":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank(group)))
    return torch.device("cuda", local)


def join_group(num_shards: int, device) -> Optional[ProcessGroup]:
    """The group of a run with `num_shards` data shards: None for one shard
    (the one-card path issues no collective), the default group when this
    process already belongs to one (`launch`), else a group formed from the
    launcher's environment (`WORLD_SIZE`, `RANK`, `MASTER_ADDR`, ...). Its
    size must be `num_shards`."""
    if num_shards <= 1:
        return None
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(f"{num_shards} data shards need {num_shards} processes: run "
                               "through the CLI (which spawns them) or a launcher such as "
                               "torchrun")
        backend = backend_for(device)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
        dist.init_process_group(backend, timeout=_TIMEOUT)
    group = dist.group.WORLD
    if dist.get_world_size(group) != num_shards:
        raise ValueError(f"{num_shards} data shards, but the process group has "
                         f"{dist.get_world_size(group)} ranks")
    return group


def host_group(group: ProcessGroup) -> ProcessGroup:
    """A gloo group over the ranks of `group` (the default group), for host
    values (flags, barriers, generator states): `group` itself when it is
    gloo, else a new one. Every rank must call it, in the same order; keep
    the result."""
    if dist.get_backend(group) == "gloo":
        return group
    return dist.new_group(backend="gloo", timeout=_TIMEOUT)


def _all_reduce(t: torch.Tensor, group: ProcessGroup) -> None:
    dist.all_reduce(t, group=group)
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += t.numel() * t.element_size()


def all_reduce_sum(tensors: Sequence[torch.Tensor], group: ProcessGroup) -> List[torch.Tensor]:
    """The sums over the ranks of `tensors` (one dtype, one device), through
    one flat buffer and one collective; new tensors, views of that buffer,
    in the inputs' shapes. Not differentiable."""
    tensors = list(tensors)
    if len({(t.dtype, t.device) for t in tensors}) != 1:
        raise ValueError("all_reduce_sum takes tensors of one dtype on one device")
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _all_reduce(flat, group)
    return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        # the gradient of each rank's input is the sum of every rank's
        # output gradient: again an all-reduce, itself differentiable
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum_differentiable(t: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable to any order: the
    backward all-reduces the gradient. Every rank must reach the backward
    too (the train step's BN backward does, in the same order on every
    rank)."""
    return _AllReduceSum.apply(t, group)


def gather_rows(t: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """The ranks' `t` stacked along dim 0 in rank order, (world·B, …): each
    rank writes its rows into a zero-filled (world, B, …) buffer and the
    buffer is all-reduced (gloo has no `all_gather` of CUDA tensors). `t`
    must have the same shape on every rank; not differentiable."""
    rank, world = world_of(group)
    buf = torch.zeros((world, *t.shape), dtype=t.dtype, device=t.device)
    buf[rank] = t.detach()
    _all_reduce(buf, group)
    return buf.reshape(world * t.shape[0], *t.shape[1:])


def broadcast_state(tensors: Sequence[torch.Tensor], group: ProcessGroup, src: int = 0) -> None:
    """Overwrite `tensors` in place with rank `src`'s, one flat broadcast per
    (dtype, device)."""
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in by_kind.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=src, group=group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view(t.shape))


def shard_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rows [rank·B/world, (rank + 1)·B/world) of a global batch of B rows."""
    if x.shape[0] % world:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over {world} ranks")
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def any_rank(flag: bool, host: ProcessGroup) -> bool:
    """True on every rank when `flag` is true on any, through the gloo
    `host` group (`host_group`): it does not wait on the card."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, group=host)
    return bool(t.item())


def host_barrier(host: ProcessGroup) -> None:
    """A barrier on the gloo `host` group: it does not wait on the card."""
    dist.barrier(group=host)


# ------------------------------------------------------------------ launcher
def _rank_entry(fn, rank: int, world: int, init_file: str, backend: str, args: tuple,
                results) -> None:
    """One spawned rank: form the group, run `fn(group, *args)`, report."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, store=dist.FileStore(init_file, world), rank=rank,
                                world_size=world, timeout=_TIMEOUT)
        try:
            value = fn(dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        # pickled here, by value: torch's queue would pass tensors as
        # shared-memory handles that die with this process
        results.put((rank, True, pickle.dumps(value)))
    except BaseException:  # noqa: BLE001 — reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def launch(fn: Callable, world_size: int, *args, backend: str = "gloo",
           timeout: float = 3600.0) -> list:
    """Run `fn(group, *args)` in `world_size` spawned processes, rank r in
    process r, and return their return values in rank order (pickled by
    value: return host values, not CUDA tensors). `fn` must be importable
    by name (a module-level function). With NCCL, rank r runs on `cuda:r`.

    The ranks meet through a `FileStore` in a fresh temporary directory (no
    port is opened). A rank that raises or exits without a result fails the
    launch with its traceback, and the launcher stops the other ranks (which
    may wait in a collective for it); so does `timeout` seconds without
    every result."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="skd_ranks_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_entry,
                             args=(fn, r, world_size, init_file, backend, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            out: list = [None] * world_size
            pending = set(range(world_size))
            deadline = time.monotonic() + timeout
            while pending:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks {sorted(pending)} gave no result in "
                                           f"{timeout:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                out[rank] = pickle.loads(value)
                pending.discard(rank)
            for p in procs:
                p.join(timeout=60)
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
