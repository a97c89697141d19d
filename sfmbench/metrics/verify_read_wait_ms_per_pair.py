"""Host ms per pair classified that two-view verification waits on the
card in its read of the RANSAC results: the `wait_s` of the program's
span `verify.read` over the `classified` of the window's untraced jobs
(sfmbench.program_roots). None where the program records no such
roots."""

from sfmbench import program_roots


def read(ctx):
    w = program_roots.window(ctx, "verify")
    if w is None:
        return None
    recs, pairs = w
    return 1e3 * sum(r["spans"].get("verify.read", {}).get("wait_s", 0.0)
                     for r in recs) / pairs
