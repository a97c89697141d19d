"""Host ms per Levenberg-Marquardt step of the sharded solve on rank 0:
the seconds of the program's `ba.sharded.solve` roots less those of
their `ba.sharded.local` (the local problem, built once a solve), over
their `lm_steps`, for the window's untraced solves
(sfmbench.program_roots_sharded). None where the program records no
such roots."""

from sfmbench import program_roots_sharded as roots


def read(ctx):
    w = roots.window(ctx)
    if w is None:
        return None
    recs, steps = w
    return 1e3 * (roots.span_seconds(recs, "ba.sharded.solve") -
                  roots.span_seconds(recs, "ba.sharded.local")) / steps
