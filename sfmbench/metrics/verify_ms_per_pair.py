"""Host ms of two-view verification per pair classified:
FeaturePipeline.timings["verification"] summed over the window's
untraced jobs, over FeaturePipeline.num_classified summed."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("classified"):
        return None
    return 1e3 * c["verification_s"] / c["classified"]
