"""Host ms per Levenberg-Marquardt step: the untraced solves' seconds
(each ended by a sync) over their BAStats.num_iterations summed."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("iterations"):
        return None
    return 1e3 * c["solve_s"] / c["iterations"]
