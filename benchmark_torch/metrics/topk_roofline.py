"""topk_roofline: B1 (``ops/topk.py::fused_topk``) against its bound. Per
search: the rows and the batch's queries read once and (score, id) pairs
written once at 3.35 TB/s, or 2 B N D operations at 989 TFLOP/s, the
larger; B is the dispatch's real queries, N the corpus's rows. Summed over
the searches traced, over the device time inside their spans."""
from benchmark_torch.harness import readers
from benchmark_torch.harness.arith import flat_topk_work


def read(ctx):
    return readers.search_roofline(ctx, "flat", lambda s: flat_topk_work(s["b"], s["n"], s["d"], s["k"], s["elem"]))
