"""device_idle_share.<kind>: the share of a unit of work (a step, an eval,
a request) in which the card ran no kernel or copy, in %: one less the
device-busy seconds a unit in the traced window over the host seconds a
unit in the untraced window before it. The profiler slows the host, so
the traced window's own length would read the host's path as idle."""


def read(ctx):
    if not ctx.work.get("units") or not ctx.timed.get("units"):
        return None
    return 100.0 * (1.0 - ctx.busy_s_per_unit / ctx.timed_s_per_unit)
