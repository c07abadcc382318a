"""placement_s: the engine's own host-clock seconds per placement step of
the corpus (``MultiIndexEngine.placement_seconds``: stack and copy to the
device, or the IVF build's steps), summed."""


def read(ctx):
    return sum(ctx.placement_seconds.values()) if ctx.placement_seconds else None
