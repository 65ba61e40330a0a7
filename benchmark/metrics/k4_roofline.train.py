"""k4_roofline.train: K4 (``csrc/ell_gather_reduce.cu``) in training, the
sum of each traced call's least time (`benchmark.counts.kernels.k4_least_s`,
from the call's own table and inputs) over the device time of its two
kernels, in %."""

from benchmark.counts.kernels import K4_KERNELS, k4_least_s


def read(ctx):
    calls = ctx.calls["k4"]
    t = ctx.kernel_s(K4_KERNELS)
    if not calls or t <= 0 or not ctx.work.get("steps"):
        return None
    return 100.0 * sum(k4_least_s(*c) for c in calls) / t
