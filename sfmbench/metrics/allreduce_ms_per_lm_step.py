"""Device ms per Levenberg-Marquardt step in NCCL's kernels on rank 0's
card, in the traced solve: every kernel whose name holds `nccl`, summed
by name, over the traced solve's LM steps. An NCCL kernel runs from the
moment its rank reaches the collective until every rank has, so this is
the collectives' own time and the wait for the slowest rank."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["counters"].get("iterations"):
        return None
    nccl = sum(s for n, s in tr["kernel_s"].items() if "nccl" in n.lower())
    return 1e3 * nccl / tr["counters"]["iterations"]
