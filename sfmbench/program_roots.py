"""The program's own records of an untraced window, for the readers of
per-layer metrics whose source is a span or counter of the port.

The port (dagsfm_tpu_torch.utils.observability) keeps its last finished
root spans, each with its spans' seconds, waits and reads and its
counters. A window's records are the newest roots of one kind that ran
under no profiler, taken newest first until their counter sums to
exactly the window's total in the harness's counters. A program that
keeps no such records gives None, and so does a run of roots whose
counts do not add up to the window's.
"""

from dagsfm_tpu_torch.utils import observability as obs

# kind -> (root span, its counter, the harness counter that is the
# window's total, the counter the metrics divide by)
KINDS = {"verify": ("verify.job", "pairs", "pairs", "classified"),
         "ba": ("ba.solve", "lm_steps", "iterations", "lm_steps")}


def window(ctx, kind: str):
    """(records oldest first, the sum of their unit counter) for the
    window of ctx, or None."""
    name, counter, total_key, unit = KINDS[kind]
    total = ctx["counters"].get(total_key)
    roots = getattr(obs, "roots", None)
    if roots is None or not total:
        return None
    recs, acc = [], 0
    for rec in reversed(roots()):
        if rec["name"] != name or rec["profiled"]:
            continue
        recs.append(rec)
        acc += rec["counters"].get(counter, 0)
        if acc >= total:
            break
    units = sum(r["counters"].get(unit, 0) for r in recs)
    if acc != total or not units:
        return None
    return recs[::-1], units
