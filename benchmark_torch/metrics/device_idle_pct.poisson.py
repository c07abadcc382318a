"""Share of the traced window with no kernel, copy or set on the device
(the profiler's ``record_function`` ranges left out)."""
from benchmark_torch.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
