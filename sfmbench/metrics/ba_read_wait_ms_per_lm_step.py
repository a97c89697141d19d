"""Host ms per LM step that bundle adjustment waits on the card in its
explicit reads (the CG loop's stopping test, the costs): `wait_s`
summed over every span under the program's `ba.solve` roots, over their
`lm_steps`, for the window's untraced solves (sfmbench.program_roots).
None where the program records no such roots."""

from sfmbench import program_roots


def read(ctx):
    w = program_roots.window(ctx, "ba")
    if w is None:
        return None
    recs, steps = w
    return 1e3 * sum(e["wait_s"] for r in recs
                     for e in r["spans"].values()) / steps
