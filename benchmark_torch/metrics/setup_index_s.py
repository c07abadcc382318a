"""setup_index_s: seconds of the index reads inside the engine's cold loads
(``VectorIndex.load``, packed or JSONL), from the program's set-up account
before the window (``harness/setup_parts.py``). Program counter, host
clock."""
from benchmark_torch.harness import setup_parts


def read(ctx):
    return setup_parts.total(ctx, "index_read_s")
