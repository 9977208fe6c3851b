"""Process start to the window's opening (s)."""


def read(ctx):
    return ctx.setup_s
