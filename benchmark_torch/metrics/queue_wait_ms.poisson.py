"""queue_wait_ms.poisson: mean host milliseconds a request waited in the
batcher (``services/batcher.py``), from its ``submit`` to the start of the
dispatch that took it: the program's ``tt.batcher.queue`` records, one a
request, over the traced window."""
from benchmark_torch.harness import program


def read(ctx):
    return program.mean_ms(program.records(ctx, "tt.batcher.queue"))
