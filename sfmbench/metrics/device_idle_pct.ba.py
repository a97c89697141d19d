"""The share of the untraced window in which the card is idle: one less
the card's busy seconds per LM step in the traced solve (from the
trace) over the untraced window's seconds per LM step. The traced
solve's own span is not used: the profiler slows the host's launches,
and so stretches the idle gaps, but not the kernels."""


def read(ctx):
    tr, c = ctx["trace"], ctx["counters"]
    if tr is None or not tr["counters"].get("iterations") or \
            not c.get("iterations") or ctx["window_s"] <= 0:
        return None
    busy = tr["busy_s"] / tr["counters"]["iterations"]
    return 100.0 * (1.0 - busy / (ctx["window_s"] / c["iterations"]))
