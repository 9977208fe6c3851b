"""The decode steps' model FLOPs (the weights' matmuls and attention over
each row's actual length, ``costs.decode_token_flops``) over the sum of
the decode.chunk spans, as a share of the bf16 peak (%)."""
from perfbench import costs



def read(ctx):
    c, cfg = costs, ctx.cfg
    flops = dur = 0.0
    for s in ctx.span_steps():
        ch = s.get("decode_chunk")
        if ch is None:
            continue
        dur += ch["t1"] - ch["t0"]
        for rid, j0, k in s["decoded"]:
            P = ctx.prompt_len[rid]
            for j in range(max(j0, 1), j0 + k):  # token j read P + j tokens
                flops += c.decode_token_flops(cfg, P + j)
    if not dur:
        return None
    return 100.0 * flops / dur / c.PEAK_BF16_FLOPS
