"""Pair matching with the pair batch cut into shards over the ranks.

Port of dagsfm_tpu/parallel/matching_sharded.py: the pair batch, padded
to a multiple of D with its last pair, is cut into D contiguous shards;
each rank matches its own shards with the plain f32 matcher
(`features.matching.match_pair_batch`, the reference's XLA matcher, not
a Pallas kernel), the shards are gathered back to every rank, and the
host trims each pair's matches as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

from dagsfm_tpu_torch import device as devmod
from dagsfm_tpu_torch.features.matching import (MatchingOptions,
                                                match_pair_batch)
from dagsfm_tpu_torch.parallel.mesh import process_group


def match_pairs_sharded(descriptors: dict, masks: dict, pairs: list,
                        opts: MatchingOptions = MatchingOptions(),
                        num_shards: int | None = None,
                        device=None) -> dict:
    """Match image pairs in `num_shards` shards (default: one per rank)
    on `device` (the GPU unless "cpu" is asked).

    descriptors: image_id -> (K, 128) normalized float; masks: image_id
    -> (K,) bool. All images share K. Returns pair -> (M, 2) uint32, as
    features.matching.match_pairs."""
    dev = devmod.resolve(device)
    if not pairs:
        return {}
    group, rank, world = process_group()
    D = num_shards or world
    B = len(pairs)
    padded = pairs + [pairs[-1]] * ((-B) % D)
    Bd = len(padded) // D

    def stack(src, idx, dtype):
        return torch.as_tensor(np.stack([src[p[idx]] for p in padded]),
                               dtype=dtype, device=dev)

    d1, d2 = stack(descriptors, 0, torch.float32), \
        stack(descriptors, 1, torch.float32)
    m1, m2 = stack(masks, 0, torch.bool), stack(masks, 1, torch.bool)
    # shard d is rows [d Bd, (d+1) Bd) and lives on rank d % world; a
    # rank's slot s holds its shard rank + s world
    slots = -(-D // world)
    mine = torch.zeros((slots, Bd) + (d1.shape[1], 2), dtype=torch.int32,
                       device=dev)
    for s, d in enumerate(range(rank, D, world)):
        rows = slice(d * Bd, (d + 1) * Bd)
        mine[s] = match_pair_batch(d1[rows], d2[rows], m1[rows], m2[rows],
                                   opts)[0]
    if group is not None:
        parts = [torch.empty_like(mine) for _ in range(world)]
        tdist.all_gather(parts, mine, group=group)
    else:
        parts = [mine]
    matches = torch.cat([parts[d % world][d // world] for d in range(D)]
                        ).cpu().numpy()
    out = {}
    for k in range(B):
        m = matches[k]
        m = m[m[:, 0] >= 0][: opts.max_num_matches]
        out[padded[k]] = m.astype(np.uint32)
    return out
