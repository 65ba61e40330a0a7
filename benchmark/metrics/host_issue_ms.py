"""host_issue_ms.<kind>: host milliseconds a unit of work (a step, an
eval, a request) in which the host was not blocked on the card: the
program's calls' spans (``train.call``, ``eval.run``, ``serve.request``)
less the ``sync.*`` spans inside them, over the units (`benchmark.spans`).
Read on the host under the traced window's profiler, which slows the
host, so it is compared parent against change under that same profiler.
The note gives each span name's own time a unit (less its children's),
the parts of the calls' time, the largest first."""

from benchmark.spans import window_tape


def read(ctx):
    tape = window_tape(ctx)
    if tape is None or not tape.calls:
        return None
    per = 1e-6 / tape.units
    parts = sorted(tape.own_ns_by_name().items(), key=lambda kv: -kv[1])
    note = "own ms a unit: " + ", ".join(f"{name} {ns * per:.4g}" for name, ns in parts)
    return tape.issue_ns() * per, note
