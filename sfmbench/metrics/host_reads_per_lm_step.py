"""Explicit device-to-host reads per LM step of bundle adjustment:
`reads` summed over every span under the program's `ba.solve` roots,
over their `lm_steps`, for the window's untraced solves
(sfmbench.program_roots). None where the program records no such
roots."""

from sfmbench import program_roots


def read(ctx):
    w = program_roots.window(ctx, "ba")
    if w is None:
        return None
    recs, steps = w
    return sum(e["reads"] for r in recs for e in r["spans"].values()) / steps
