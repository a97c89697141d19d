"""Process-group helpers for the parallel layer.

Port of dagsfm_tpu/parallel/mesh.py. The JAX package lays its shards on a
device mesh; here a problem is cut into D shards (D = the reference's
number of devices) and shard d lives on rank d % W of a torch.distributed
process group of W ranks. Each rank sums the partial blocks of its own
shards and makes one `all_reduce` where the reference makes one `psum`
(a group of one rank makes it too). Without a process group every shard
lives in this process, and the reduce is the identity.

`init_ranks` starts the process group of one rank and binds the rank to
its card: NCCL on cards, gloo on the CPU. Each collective counts
`allreduce` and `allreduce_bytes` on the open span's root
(`utils.observability`).
"""

from __future__ import annotations

import datetime
import heapq
import os

import numpy as np
import torch
import torch.distributed as tdist

from dagsfm_tpu_torch.utils import observability as obs


def init_ranks(rank: int | None = None, world_size: int | None = None,
               address: str | None = None, timeout_s: float = 600.0,
               device=None) -> torch.device:
    """Start this process's rank of the default process group and return
    its device. Under `torchrun` pass nothing (RANK, WORLD_SIZE,
    LOCAL_RANK and MASTER_ADDR/PORT come from the environment); else
    pass rank, world_size and address (`tcp://host:port`, where rank 0
    listens). The device is `device` when given, else `cuda:<local
    rank>` (LOCAL_RANK, or the rank modulo the cards) when a card is
    present, else the CPU; the rank is bound to it (`cuda.set_device`),
    so that `cuda` means that card. NCCL on a card, gloo on the CPU. A
    collective that waits longer than timeout_s on a lost rank raises
    (gloo) or aborts the process (NCCL's watchdog)."""
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), \
            int(os.environ["WORLD_SIZE"])
        address = "env://"
    if device is None:
        if torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            device = torch.device("cuda", local)
        else:
            device = torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    tdist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=address,
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def process_group() -> tuple:
    """(group, rank, world_size): the default process group, or (None, 0,
    1) when torch.distributed is not set up."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.group.WORLD, tdist.get_rank(), tdist.get_world_size()
    return None, 0, 1


def own_shards(num_shards: int) -> list:
    """The shards d of [0, num_shards) with d % world_size == rank."""
    _, rank, world = process_group()
    return list(range(rank, num_shards, world))


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the ranks, on every rank, in place (x itself without
    a process group)."""
    group = process_group()[0]
    if group is not None:
        tdist.all_reduce(x, group=group)
        obs.count("allreduce")
        obs.count("allreduce_bytes", x.numel() * x.element_size())
    return x


def all_reduce_many(*xs: torch.Tensor) -> tuple:
    """all_reduce of several tensors of one dtype and device in one
    collective: packed flat, reduced, unpacked."""
    if process_group()[0] is None:
        return xs
    flat = all_reduce(torch.cat([x.reshape(-1) for x in xs]))
    out, k = [], 0
    for x in xs:
        out.append(flat[k: k + x.numel()].reshape(x.shape))
        k += x.numel()
    return tuple(out)


def partition_balanced(sizes: np.ndarray, num_bins: int):
    """Greedy largest-first balanced partition (ref: cluster-size-sorted
    job ordering, distributed_mapper_controller.cpp:675-679).

    Returns bin index per item. Each item goes to the least loaded bin,
    the lowest index among equal loads (a heap of (load, bin)).
    """
    order = np.argsort(-np.asarray(sizes))
    heap = [(0.0, b) for b in range(num_bins)]
    bins = np.empty(len(order), np.int32)
    for k, s in enumerate(np.asarray(sizes, np.float64)[order].tolist()):
        load, b = heap[0]
        bins[k] = b
        heapq.heapreplace(heap, (load + s, b))
    assign = np.zeros(len(sizes), np.int32)
    assign[order] = bins
    return assign
