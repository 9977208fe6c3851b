"""Host ms an admission costs: the window's engine.step spans less their
decode.chunk spans, over the requests admitted in those steps.  It
includes each first token's readback."""


def read(ctx):
    dur, n = 0.0, 0
    for s in ctx.span_steps():
        ch = s.get("decode_chunk")
        es = s["engine_step"]
        dur += (es["t1"] - es["t0"]) - (ch["t1"] - ch["t0"] if ch else 0.0)
        n += len(s["admitted"])
    return 1000.0 * dur / n if n else None
