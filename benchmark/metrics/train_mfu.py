"""train_mfu: the training step's least time over its measured time, in %.

Least time: the larger of the step's model operations over the peak at
the configured dtype and its model bytes over the HBM rate, counted from
the configuration's shapes (`benchmark.counts.lightgcn.train_step_least`).
Measured: the untraced window's seconds over its steps (the profiler
slows the host, so the traced window's would read low)."""

from benchmark.counts.lightgcn import train_step_least


def read(ctx):
    if not ctx.timed.get("steps"):
        return None
    least, bound = train_step_least(ctx.cfg)
    return 100.0 * least / ctx.timed_s_per_unit, f"bound by {bound}"
