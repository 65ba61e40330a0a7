"""eval_mfu: one full-catalog eval's least time (one propagation and every
test user's scores, `benchmark.counts.lightgcn.eval_least`, in float32)
over the measured time of an eval in the untraced window, in %."""

from benchmark.counts.lightgcn import eval_least


def read(ctx):
    w = ctx.timed
    if not w.get("evals"):
        return None
    least, bound = eval_least(ctx.cfg, w["n_test_users"], w["words"], w["k"])
    return 100.0 * least / ctx.timed_s_per_unit, f"bound by {bound}"
