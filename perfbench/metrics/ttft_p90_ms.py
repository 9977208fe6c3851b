"""90th percentile, over the requests due in the window of an open cell,
of the time from when each was due to the delivery of its first token
(ms); a request still waiting after the drain has no sample and counts
as failed."""
from perfbench import stats


def read(ctx):
    xs, _ = stats.ttft_samples(ctx.due, ctx.first, ctx.t_open, ctx.t_close)
    p = stats.percentile(xs, 90)
    return None if p is None else 1000.0 * p
