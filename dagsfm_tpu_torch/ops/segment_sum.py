"""Fixed-order segment sums: every per-target sum of the port adds its
terms in one fixed order, with no atomics, so a run gives the same bits
every time, on a GPU too. `index_add_`'s atomics on a GPU add in no fixed
order, and a mapping then differed from run to run in its last bits.

`segments` groups rows by target once; `segment_sum` sums a tensor's
rows by those groups. Bundle adjustment, its Schur product, rotation
averaging, the coordinate frame's Hough votes and the Poisson solver's
splats all sum through here. `mv` and `mtv` are the batched block
products that go with them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# `segment_sum` adds each run in chunks of at most this many rows, then
# the chunk sums of each target: CUDA's segment_reduce walks a run with
# one thread per output element, and a camera shared by every image
# makes a run of millions of observation pairs
SEGMENT_CHUNK = 256


class Segments(NamedTuple):
    """Rows of a tensor grouped by target: rows `order` (None: the rows
    as they are) fall into consecutive runs of `lengths`, one run per
    target in target order, each run in the rows' original order, and
    each run into `chunk_counts` consecutive `chunks` (an empty run into
    one empty chunk)."""
    order: torch.Tensor | None   # (M,) int64
    lengths: torch.Tensor        # (T,) int64
    chunks: torch.Tensor         # (K,) int64, rows per chunk
    chunk_counts: torch.Tensor   # (T,) int64, chunks per target


def segments(keys, num: int, device, order: bool = True) -> Segments:
    """Segments of the rows by target `keys` (a host int array or a
    tensor) in [0, num), built on `device`: a stable sort by key,
    SEGMENT_CHUNK rows per chunk, one read-back for the number of
    chunks."""
    keys = (keys.to(device, torch.int64) if isinstance(keys, torch.Tensor)
            else torch.as_tensor(np.asarray(keys, np.int64), device=device))
    lengths = torch.bincount(keys, minlength=num)
    ordr = torch.argsort(keys, stable=True) if order else None
    counts = torch.clamp(-(-lengths // SEGMENT_CHUNK), min=1)   # empty: one
    chunks = torch.full((int(counts.sum()),), SEGMENT_CHUNK,
                        dtype=torch.int64, device=device)
    chunks[torch.cumsum(counts, 0) - 1] = \
        lengths - SEGMENT_CHUNK * (counts - 1)
    return Segments(ordr, lengths, chunks, counts)


def segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """(T, ...) sums of x's rows per target in a fixed order: the same
    bits on every run, on a GPU too. The chunk sums first, then their
    sums per target (empty targets 0)."""
    if seg.order is not None:
        x = x[seg.order]
    part = torch.segment_reduce(x, "sum", lengths=seg.chunks, axis=0)
    return torch.segment_reduce(part, "sum", lengths=seg.chunk_counts,
                                axis=0)


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched A x: (..., m, n) by (..., n) into (..., m)."""
    return (A @ x[..., None])[..., 0]


def mtv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched Aᵀ x: (..., m, n) by (..., m) into (..., n)."""
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]
