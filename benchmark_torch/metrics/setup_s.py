"""setup_s: process start to the first timed message: index load and
placement, weights, server start, warm-up (on a checkout's first run also
the corpus write and the kernel build). Host clock."""


def read(ctx):
    return ctx.setup_s
