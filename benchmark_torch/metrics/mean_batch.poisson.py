"""Requests per batcher dispatch (services/batcher.py) over the whole
window, from the program's counters at ``/api/system/rag/status``."""
from benchmark_torch.harness import readers


def read(ctx):
    return readers.mean_batch(ctx)
