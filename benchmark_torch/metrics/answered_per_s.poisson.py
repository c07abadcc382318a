"""answered_per_s.poisson: messages of the open loop's window answered with
sources, over the seconds from the window's start to the last of those
answers, or to the window's end where every answer came before it. Below
the system's capacity it reads the offered rate; it falls when messages
fail or the system no longer keeps up (a backlog drains after the window
and its time counts). Host clock."""


def read(ctx):
    span = getattr(ctx, "answered_span_s", None)
    return ctx.answered / span if ctx.answered and span else None
