"""serve_mfu: the request path's least time over its measured time, in %.
Least time: the traced window's requests' K1 least times (the scoring is
a request's only model work, `benchmark.counts.kernels.k1_least_s`) over
their count; measured: the untraced window's seconds over its requests."""

from benchmark.counts.kernels import k1_least_s


def read(ctx):
    calls, w = ctx.calls["k1"], ctx.work
    if not w.get("requests") or not calls or not ctx.timed.get("requests"):
        return None
    least = sum(k1_least_s(B, m, d, W, w["k"]) for B, m, d, W in calls) / w["requests"]
    return 100.0 * least / ctx.timed_s_per_unit
