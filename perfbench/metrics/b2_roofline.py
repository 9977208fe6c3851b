"""B2's share of its roofline in the profiled stretch (%): the least time
the chip could take for the reads the stretch's decode steps need
(``costs.b2_step_work`` at each row's actual length, every layer; bytes
over HBM bandwidth or FLOPs over the fp32 peak, the larger) over the
device time of B2's kernels, found by their symbols."""
from perfbench import costs


SYMBOLS = ("qda_split_kernel", "qda_combine_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.stretch_rows:
        return None
    dev = sum(s for name, s in ctx.trace["op_seconds"].items()
              if any(sym in name for sym in SYMBOLS))
    if not dev:
        return None
    c, cfg = costs, ctx.cfg
    pool = ctx.pool or {}
    flops = nbytes = 0.0
    for lengths in ctx.stretch_rows:
        f, b = c.b2_step_work(cfg, lengths,
                              page_size=pool.get("page_size", 16))
        flops += f * cfg.n_layers
        nbytes += b * cfg.n_layers
    bound = max(nbytes / c.PEAK_HBM_BYTES_S, flops / c.PEAK_FP32_FLOPS)
    return 100.0 * bound / dev
