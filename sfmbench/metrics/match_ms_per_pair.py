"""Host ms of matching per pair: FeaturePipeline.timings["matching"]
(each ends in the host read of the matches) summed over the window's
untraced jobs, over the pairs they matched."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("pairs"):
        return None
    return 1e3 * c["matching_s"] / c["pairs"]
