"""rerank_ms: device time per batcher dispatch (``tt.batcher.dispatch``) of
the kernels launched inside the program's ``tt.rerank.launch`` and
``tt.rerank.finish`` spans (``Reranker.score_tokenized_async`` and the
finisher it returns). Device trace."""
from benchmark_torch.harness import readers


def read(ctx):
    return readers.per_batch_ms(ctx, "tt.rerank.launch", "tt.rerank.finish")
