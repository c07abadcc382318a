"""answered_per_s: messages whose ``sources`` frame, with sources, reached
the client inside the window, over the window's length. Host clock."""


def read(ctx):
    return ctx.answered / ctx.window_s if ctx.answered else None
