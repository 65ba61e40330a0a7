"""head_real_share.hstu: the share of the slots the HSTU head computes a
step that are real, in %: the loss's slots a step (a real input and a
real target; the window's ``real_slots``, counted from the benchmark's
own sequences) over the slots whose negatives the program drew a step,
from its ``hstu.negatives`` spans in the traced window (``shape`` (slots
computed, K), one a step, recorded eagerly, so replayed steps count). A
head over real slots only reads about 100; one over every slot of the
padded batch reads the real share of the batch. None where the program
records no such spans (a program without HSTU), or not one a step."""

from benchmark.spans import window_tape


def read(ctx):
    tape = window_tape(ctx)
    if tape is None or "real_slots" not in ctx.work:
        return None
    drawn = [s for s in tape.spans if s.name == "hstu.negatives"]
    if len(drawn) != tape.units:
        return None
    computed = sum(s.attrs["shape"][0] for s in drawn) / tape.units
    return 100.0 * ctx.work["real_slots"] / computed
