"""topk_roofline: B1 (``ops/topk.py::fused_topk``) against its bound. Per
flat search (a ``tt.search`` record without ``nprobe``): the rows and the
batch's queries read once and (score, id) pairs written once at 3.35 TB/s,
or 2 B N D operations at 989 TFLOP/s, the larger; B is the dispatch's real
queries (the ``queries`` of the search's parent ``tt.query_step``, not the
padded batch the search counts), N and k the search's own counts, D the
configuration's ``corpus.dim``, the rows in its ``dtype``. Summed over the
searches traced, over the device time inside their ``tt.search`` spans."""
from benchmark_torch.harness import program, readers
from benchmark_torch.harness.arith import flat_topk_work

ELEM_BYTES = {"float32": 4, "int8": 1}  # else bf16 or fp16 rows


def read(ctx):
    searches = [r for r in program.records(ctx, "tt.search") if "nprobe" not in r.counts]
    steps = program.started(ctx, "tt.query_step")
    d, elem = ctx.config["corpus"]["dim"], ELEM_BYTES.get(ctx.config.get("dtype"), 2)

    def work(r):
        step = steps.get(r.parent)
        if step is None:  # its query step began before the trace: its real queries are not known
            return None
        return flat_topk_work(step.counts["queries"], r.counts["n"], d, r.counts["k"], elem)
    return readers.search_roofline(ctx, searches, work)
