"""Model FLOPs of every prefill and decode step in the window's steps
(``costs.prefill_flops``, ``costs.decode_token_flops``) over the sum of
their engine.step spans, as a share of the bf16 peak (%)."""
from perfbench import costs



def read(ctx):
    c, cfg = costs, ctx.cfg
    flops = dur = 0.0
    for s in ctx.span_steps():
        es = s["engine_step"]
        dur += es["t1"] - es["t0"]
        for rid in s["admitted"]:
            flops += c.prefill_flops(cfg, ctx.prompt_len[rid])
        for rid, j0, k in s["decoded"]:
            P = ctx.prompt_len[rid]
            for j in range(max(j0, 1), j0 + k):
                flops += c.decode_token_flops(cfg, P + j)
    if not dur:
        return None
    return 100.0 * flops / dur / c.PEAK_BF16_FLOPS
