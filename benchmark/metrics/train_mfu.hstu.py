"""train_mfu.hstu: the HSTU training step's least time over its measured
time, in %. Least time: the larger of the step's model operations at its
real slots (the products, the attention's causal pairs of real inputs,
the head at the loss's slots, forward and backward) over the float32
peak and its bytes (the head's rows read and their gradient written,
Adam's traffic) over the HBM rate (`benchmark.counts.hstu`), the real
slots a step counted from the benchmark's own sequences (the window's
``real_slots`` and ``causal_pairs``); measured: the untraced window's
seconds over its steps. The padding the program computes counts against
it."""

from benchmark.counts.hstu import train_step_least


def read(ctx):
    w = ctx.timed
    if not w.get("steps") or "real_slots" not in w:
        return None
    least, bound = train_step_least(ctx.cfg, w["real_slots"], w["causal_pairs"])
    return 100.0 * least / ctx.timed_s_per_unit, f"bound by {bound}"
