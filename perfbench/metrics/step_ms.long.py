"""Sum of the engine's decode.chunk spans over the decode steps they ran
(ms a step), over the window's steps.  The span ends after the chunk's
readback, a device sync."""


def read(ctx):
    dur = steps = 0.0
    for s in ctx.span_steps():
        ch = s.get("decode_chunk")
        if ch is not None:
            dur += ch["t1"] - ch["t0"]
            steps += ch["args"].get("steps", 0)
    return 1000.0 * dur / steps if steps else None
