"""session_io_ms.poisson: host milliseconds a message spends in the session
service's reads and saves on the event loop (``get_session``,
``add_message``, ``set_title`` in ``server/routes/chat.py::ws_chat``): the
program's ``tt.route.session_io`` spans, summed over the traced window, per
``tt.ws.message`` started in it."""
from benchmark_torch.harness import program


def read(ctx):
    return program.per_message_ms(ctx, "tt.route.session_io")
