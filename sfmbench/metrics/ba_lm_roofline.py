"""The LM steps' share of their bandwidth roofline in the traced solve:
the least time the card could take for the bytes its LM steps must move
(counts.ba_lm_step_bytes, at the solve's CG iterations per step) at the
HBM bandwidth, over the seconds in which the card ran anything in the
trace of that solve."""

from sfmbench import counts, peaks


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    c = tr["counters"]
    if not c.get("iterations"):
        return None
    per_step = counts.ba_lm_step_bytes(c["N"], c["P"], c["I"], c["C"],
                                       c["cg_iterations"] / c["iterations"])
    return 100.0 * c["iterations"] * per_step / peaks.HBM_BYTES_PER_S \
        / tr["busy_s"]
