"""host_syncs.<kind>: the times the host blocked on the card a unit of
work (a step, an eval, a request) in the traced window: the program's
``sync.*`` spans, one a blocking read or copy, over the units
(`benchmark.spans`)."""

from benchmark.spans import window_tape


def read(ctx):
    tape = window_tape(ctx)
    if tape is None:
        return None
    return tape.syncs() / tape.units
