"""train_mfu.bert4rec: the published BERT4Rec training step's least time
over its measured time, in %. Least time: the larger of the step's model
operations (encoder and head, forward and backward, at every slot
computed) over the float32 peak and its bytes over the HBM rate
(`benchmark.counts.bert4rec.train_step_least`); measured: the untraced
window's seconds over its steps."""

from benchmark.counts.bert4rec import train_step_least


def read(ctx):
    if not ctx.timed.get("steps"):
        return None
    least, bound = train_step_least(ctx.cfg)
    return 100.0 * least / ctx.timed_s_per_unit, f"bound by {bound}"
