"""ivf_roofline: the IVF search (``ops/ivf.py::ivf_search``: routing over
the centroids, then B4 over the probed blocks) against its bound, over the
device time inside the program's ``tt.search`` spans. Bytes: the centroids
and queries read once, each distinct probed cluster's valid rows read once,
results written once; operations: the routing product and each (query,
probe) pair's rows. The probes are recomputed after the window from the
queries and index the probe kept of each traced call (the top ``nprobe``
centroids of each query)."""
from benchmark_torch.harness import readers
from benchmark_torch.harness.arith import ivf_work


def _work(s):
    import torch

    index = s["index"]
    q = s["q"].to(index.centroids.device, torch.float32)
    probes = torch.topk(q @ index.centroids.float().T, min(s["nprobe"], index.n_clusters), dim=1).indices
    valid = torch.from_numpy((index.row_map >= 0).sum(axis=1)).to(probes.device)
    pair_rows = int(valid[probes].sum())
    probed_rows = int(valid[torch.unique(probes)].sum())
    return ivf_work(q.shape[0], index.n_clusters, q.shape[1], probed_rows, pair_rows, s["k"],
                    index.blocks.element_size())


def read(ctx):
    return readers.search_roofline(ctx, [s for _, s in readers.in_window(ctx, ctx.probe.ivf_searches)], _work)
