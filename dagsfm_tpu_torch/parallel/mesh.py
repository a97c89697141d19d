"""Process-group helpers for the parallel layer.

Port of dagsfm_tpu/parallel/mesh.py. The JAX package lays its shards on a
device mesh; here a problem is cut into D shards (D = the reference's
number of devices) and shard d lives on rank d % W of a torch.distributed
process group of W ranks. Each rank sums the partial blocks of its own
shards and makes one `all_reduce` where the reference makes one `psum`
(a group of one rank makes it too). Without a process group every shard
lives in this process, and the reduce is the identity.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist


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

    Returns bin index per item.
    """
    order = np.argsort(-np.asarray(sizes))
    loads = np.zeros(num_bins)
    assign = np.zeros(len(sizes), np.int32)
    for i in order:
        b = int(np.argmin(loads))
        assign[i] = b
        loads[b] += sizes[i]
    return assign
