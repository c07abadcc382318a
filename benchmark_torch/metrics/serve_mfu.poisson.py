"""Share of the bf16 peak (989 TFLOP/s): the encoder and cross-encoder
operations over the unpadded tokens of the queries and pairs dispatched
while the trace ran (counted from their lengths), over the traced window."""
from benchmark_torch.harness import readers


def read(ctx):
    return readers.mfu(ctx)
