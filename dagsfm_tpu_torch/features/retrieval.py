"""Image-pair generators. Port of `exhaustive_pairs` from
dagsfm_tpu/features/retrieval.py (the retrieval-based generators wait)."""

from __future__ import annotations


def exhaustive_pairs(image_ids: list) -> list:
    """All pairs (i, j, 0.0) with i < j (COLMAP ExhaustiveMatchingOptions;
    the reference's block size only groups the work, not the set)."""
    ids = sorted(image_ids)
    return [(ids[a], ids[b], 0.0)
            for a in range(len(ids)) for b in range(a + 1, len(ids))]
