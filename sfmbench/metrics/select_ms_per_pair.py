"""Host ms per pair classified of the model selection after the read of
the RANSAC results: the seconds of the program's span `verify.select`
over the `classified` of the window's untraced jobs
(sfmbench.program_roots). None where the program records no such
roots."""

from sfmbench import program_roots


def read(ctx):
    w = program_roots.window(ctx, "verify")
    if w is None:
        return None
    recs, pairs = w
    return 1e3 * sum(r["spans"].get("verify.select", {}).get("seconds", 0.0)
                     for r in recs) / pairs
