"""rerank_ms: device time per batcher dispatch of the kernels launched
inside the ``bench.rerank`` spans (``Reranker.score_pairs_async`` and the
finisher it returns). Device trace."""
from benchmark_torch.harness import readers


def read(ctx):
    return readers.per_batch_ms(ctx, "bench.rerank")
