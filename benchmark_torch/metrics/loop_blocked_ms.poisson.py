"""loop_blocked_ms.poisson: host milliseconds a message holds the event loop
with synchronous work, when no other socket is served: the program's
``tt.route.session_io``, ``tt.route.title`` (the title's LLM call) and
``tt.route.context`` spans, summed over the traced window, per
``tt.ws.message`` started in it."""
from benchmark_torch.harness import program


def read(ctx):
    return program.per_message_ms(ctx, "tt.route.session_io", "tt.route.title", "tt.route.context")
