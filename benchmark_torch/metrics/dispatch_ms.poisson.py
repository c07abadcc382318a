"""dispatch_ms.poisson: mean host milliseconds of a batcher dispatch
(``run_batch`` on the batcher's worker thread: the query step and its
readback, the rerank's tokenize, pad and launch): the program's
``tt.batcher.dispatch`` spans over the traced window."""
from benchmark_torch.harness import program


def read(ctx):
    return program.mean_ms(program.records(ctx, "tt.batcher.dispatch"))
