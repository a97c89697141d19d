"""Host ms per solve that rank 0 spends building its local problem from
its shards (the program's `ba.sharded.local` span: the shards' arrays to
the host, their kept observations joined, the problem back on the card),
over the calls of that span, for the window's untraced solves
(sfmbench.program_roots_sharded). None where the program records no
such span."""

from sfmbench import program_roots_sharded as roots


def read(ctx):
    w = roots.window(ctx)
    if w is None:
        return None
    recs, _ = w
    calls = sum(r["spans"].get("ba.sharded.local", {}).get("calls", 0)
                for r in recs)
    if not calls:
        return None
    return 1e3 * roots.span_seconds(recs, "ba.sharded.local") / calls
