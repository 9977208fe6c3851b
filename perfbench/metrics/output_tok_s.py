"""Output tokens delivered to clients in the window over its seconds."""
from perfbench import stats


def read(ctx):
    return stats.output_tok_s(ctx.deliveries, ctx.t_open, ctx.t_close)
