"""k1_roofline.<kind>: K1 (``csrc/masked_scores.cu``), the sum of each
traced call's least time (`benchmark.counts.kernels.k1_least_s`, from the
call's own shapes) over K1's device time in the traced window, in %."""

from benchmark.counts.kernels import K1_KERNELS, k1_least_s


def read(ctx):
    calls = ctx.calls["k1"]
    t = ctx.kernel_s(K1_KERNELS)
    if not calls or t <= 0:
        return None
    k = ctx.work["k"]
    return 100.0 * sum(k1_least_s(B, m, d, W, k) for B, m, d, W in calls) / t
