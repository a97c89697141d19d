"""K1's share of its roofline: the least time the card could take for
the traced unit's matching of every pair (the larger of the score products'
operations over the bf16 peak and the bytes over the HBM bandwidth,
counts.k1_*) over K1's device time in the trace (its two kernels, by
name)."""

from sfmbench import counts, peaks

K1_KERNELS = ("match_tiles", "match_epilogue_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["counters"].get("pairs"):
        return None
    c = tr["counters"]
    t = sum(s for n, s in tr["kernel_s"].items()
            if any(k in n for k in K1_KERNELS))
    if t <= 0:
        return None
    ideal = max(counts.k1_ops(c["pairs"], c["K"], c["D"])
                / peaks.BF16_FLOPS,
                counts.k1_bytes(c["pairs"], c["K"], c["D"])
                / peaks.HBM_BYTES_PER_S)
    return 100.0 * ideal / t
