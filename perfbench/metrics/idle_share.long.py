"""Share of the profiled stretch's wall time in which no operation ran
on the device (%)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
