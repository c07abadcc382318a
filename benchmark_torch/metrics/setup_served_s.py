"""setup_served_s: the app's served time in set-up (wall seconds with a
WebSocket handshake, a session create or a chat message in flight, counted
once where they overlap: the warm-up bursts and the session fill; on a
checkout's first run also the kernel build, at the first launch) less the
engine's cold load inside it, from the program's set-up account before the
window (``harness/setup_parts.py``). Program counter, host clock."""
from benchmark_torch.harness import setup_parts


def read(ctx):
    parts = setup_parts.parts(ctx)
    return None if parts is None else parts["served"]
