"""Collectives per Levenberg-Marquardt step of the sharded solve on rank
0: the `allreduce` counter of the program's `ba.sharded.solve` roots
(counted in parallel/mesh.all_reduce) over their `lm_steps`, for the
window's untraced solves (sfmbench.program_roots_sharded). None where
the program records no such roots."""

from sfmbench import program_roots_sharded as roots


def read(ctx):
    w = roots.window(ctx)
    if w is None:
        return None
    recs, steps = w
    return sum(r["counters"].get("allreduce", 0) for r in recs) / steps
