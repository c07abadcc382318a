"""query_step_ms: device time per batcher dispatch (``tt.batcher.dispatch``)
of the kernels launched inside the program's ``tt.query_step`` spans (the
flat tier's ``QueryPipeline.retrieve_batch``; on the IVF tier the query
encode and ``MultiIndexEngine.retrieve_batch``). Device trace."""
from benchmark_torch.harness import readers


def read(ctx):
    return readers.per_batch_ms(ctx, "tt.query_step")
