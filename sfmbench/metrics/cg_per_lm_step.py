"""CG iterations per LM step: BAStats.cg_iterations over
BAStats.num_iterations, summed over the window's untraced solves."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("iterations"):
        return None
    return c["cg_iterations"] / c["iterations"]
