"""95th percentile, over every delivery in the window that is not its
stream's first, of the gap since the stream's previous delivery over the
tokens the delivery carries (ms)."""
from perfbench import stats


def read(ctx):
    xs = stats.tpot_samples(ctx.deliveries, ctx.t_open, ctx.t_close)
    p = stats.percentile(xs, 95)
    return None if p is None else 1000.0 * p
