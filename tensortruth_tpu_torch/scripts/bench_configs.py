"""The BASELINE.json retrieval configs 1, 2, 4 and 5, one JSON line each.

    python -m tensortruth_tpu_torch.scripts.bench_configs [1 2 4 5]   # from the repository root; needs one CUDA card

Port of the JAX package's ``scripts/bench_configs.py``:

1. a single arXiv-paper index (2,048 chunks), exact top-10 (plain PyTorch:
   the reference's version is XLA, not Pallas);
2. a 50,000-chunk API-doc index, two modules of 6,250 parents x 4 leaves,
   through ``MultiIndexEngine`` (kernel B1 over 50,000 rows at k = 20, then
   the host's auto-merge and balance);
4. 1,000,000 chunks, ``pad_corpus_for_fused`` + ``fused_topk`` at k = 100
   (B1);
5. 2,000,000 chunks: ``build_ivf`` (512 clusters, bf16 blocks), then
   ``ivf_search`` at k = 10 for 4 queries / nprobe 8 and 32 / nprobe 16
   (kernel B4 over bf16 blocks), with the build's seconds.

Config 3 is ``bench.py``. Every config uses synthetic normalised rows from
``np.random.default_rng(config)``, as the reference does: they measure the
search, not the encoder. The rows are drawn in pieces of 65,536 from one
generator (numpy fills ``standard_normal`` in order, so the pieces are the
whole draw's rows bit for bit) and never as one float64 matrix, which at 2M
rows would be a 16 GB transient. The last line gives the process's peak
host RSS and the card.

Each config function returns (its lines, what each line's last search
found: (scores, rows) for 1, 4 and 5, node ids per query for 2).
``tiny=True`` cuts the row counts (``TINY``) and is the only size that runs
on the CPU.
"""

from __future__ import annotations

import json
import resource
import sys
import time

import numpy as np
import torch

from tensortruth_tpu_torch.index.nodes import HierarchyStore, Node
from tensortruth_tpu_torch.index.store import VectorIndex
from tensortruth_tpu_torch.ops.ivf import build_ivf, ivf_search
from tensortruth_tpu_torch.ops.topk import exact_topk, fused_topk, pad_corpus_for_fused
from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine
from tensortruth_tpu_torch.scripts import card_line, driver_device, sync

B, D, K = 32, 1024, 10
PIECE_ROWS = 65_536
N1, N2_PARENTS, N4, N5 = 2048, 6250, 1_000_000, 2_000_000
IVF5 = {"n_clusters": 512, "sample_size": 100_000, "kmeans_iters": 8}
# Reduced sizes for a CPU run (the configs' shapes otherwise unchanged).
TINY = {"n2_parents": 1250, "n4": 10_000, "n5": 8192, "ivf5": {"n_clusters": 32, "sample_size": 8192, "kmeans_iters": 8}}


def _time(fn, device, iters: int = 5):
    """(mean seconds per call after one warm-up, last output)."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync(device)
    return (time.perf_counter() - t0) / iters, out


def _corpus(rng, n: int, d: int = D, dtype=np.float32, piece_rows: int = PIECE_ROWS) -> np.ndarray:
    """(n, d) unit rows: N(0, 1) float64 draws cast to f32 and normalised, in
    pieces of ``piece_rows``, bit-equal to the reference's one draw."""
    out = np.empty((n, d), np.float32)
    for lo in range(0, n, piece_rows):
        x = rng.standard_normal((min(n, lo + piece_rows) - lo, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        out[lo : lo + x.shape[0]] = x
    return out.astype(dtype, copy=False)


def line(config: str, n: int, seconds: float, extra: dict | None = None) -> dict:
    """The reference's ``emit`` line for one config (ms and qps per 32-query batch)."""
    return {"config": config, "n_chunks": n, "ms_per_batch": round(seconds * 1e3, 2), "qps": round(B / seconds, 1),
            **(extra or {})}


def _bf16(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device).to(torch.bfloat16)


def config1(device="cuda", tiny: bool = False):
    device = driver_device(device, tiny)
    rng = np.random.default_rng(1)
    emb = _bf16(_corpus(rng, N1), device)
    q = _bf16(_corpus(rng, B), device)
    s, (vals, idx) = _time(lambda: exact_topk(q, emb, K), device)
    return [line("1:arxiv-2k-flat", N1, s)], [(vals.cpu().numpy(), idx.cpu().numpy())]


def make_index(rng, n_parents: int, module: str) -> VectorIndex:
    """``n_parents`` parents of 4 leaves each, leaf rows from ``rng``."""
    store_nodes, leaf_ids = [], []
    for p in range(n_parents):
        parent = Node(node_id=f"{module}p{p}", text="P" * 200, level=0, doc_id=module)
        kids = [
            Node(node_id=f"{module}p{p}c{c}", text="x" * 100, level=1, doc_id=module, parent_id=parent.node_id,
                 module=module)
            for c in range(4)
        ]
        parent.child_ids = [k.node_id for k in kids]
        store_nodes.append(parent)
        store_nodes.extend(kids)
        leaf_ids.extend(k.node_id for k in kids)
    store = HierarchyStore()
    store.add_all(store_nodes)
    store.finalize_leaves()
    return VectorIndex(_corpus(rng, len(leaf_ids)), leaf_ids, store, {"index_version": "1.0"})


def config2(device="cuda", tiny: bool = False):
    """The full ``MultiIndexEngine`` path with its host auto-merge and
    balance, over two modules; the engine's fused search (B1) on any device."""
    device = driver_device(device, tiny)
    n_parents = TINY["n2_parents"] if tiny else N2_PARENTS
    rng = np.random.default_rng(2)
    indexes = {"api_a": make_index(rng, n_parents, "a"), "api_b": make_index(rng, n_parents, "b")}
    engine = MultiIndexEngine(indexes, similarity_top_k=10, device=device, use_fused=True)
    q = _corpus(rng, B)
    s, results = _time(lambda: engine.retrieve_batch(q), device, iters=3)
    n = 2 * 4 * n_parents
    return [line("2:apidocs-50k-automerge", n, s, {"modules": 2})], [[[r.node_id for r in res] for res in results]]


def config4(device="cuda", tiny: bool = False):
    device = driver_device(device, tiny)
    n = TINY["n4"] if tiny else N4
    rng = np.random.default_rng(4)
    emb_np, n_actual = pad_corpus_for_fused(_corpus(rng, n))
    emb = _bf16(emb_np, device)
    del emb_np
    q = _bf16(_corpus(rng, B), device)
    s, (vals, idx) = _time(lambda: fused_topk(q, emb, 100, n_actual=n_actual), device)
    return [line("4:1M-fused-topk", n, s, {"k": 100})], [(vals.cpu().numpy(), idx.cpu().numpy())]


def corpus5(tiny: bool = False):
    """(the generator after the draw, config 5's corpus)."""
    rng = np.random.default_rng(5)
    return rng, _corpus(rng, TINY["n5"] if tiny else N5)


def config5(device="cuda", tiny: bool = False, prepared=None):
    """``prepared`` = (the generator after :func:`corpus5`'s draw, the index
    built from that corpus, its build seconds), e.g. from
    ``probe_ivf_build.run``; else drawn and built here."""
    device = driver_device(device, tiny)
    if prepared is None:
        rng, emb = corpus5(tiny)
        t0 = time.perf_counter()
        index = build_ivf(emb, **(TINY["ivf5"] if tiny else IVF5), device=device)
        build_s = time.perf_counter() - t0
        del emb
    else:
        rng, index, build_s = prepared
    n = index.n_actual
    # The IVF tier serves low latency and corpora past the card: at a large
    # batch x nprobe the probed rows approach a full scan (B * nprobe * rpc /
    # N), so the latency point (B = 4) is measured beside the bulk batch.
    q4 = _corpus(rng, 4)
    s4, found4 = _time(lambda: ivf_search(index, q4, K, nprobe=8), device, iters=3)
    b4 = {"config": "5:2M-ivf-b4-nprobe8", "n_chunks": n, "ms_per_batch": round(s4 * 1e3, 2),
          "qps": round(4 / s4, 1), "build_s": round(build_s, 1)}
    q = _corpus(rng, B)
    s, found = _time(lambda: ivf_search(index, q, K, nprobe=16), device, iters=3)
    b32 = line("5:2M-ivf-b32-nprobe16", n, s, {"build_s": round(build_s, 1), "n_clusters": index.n_clusters})
    return [b4, b32], [found4, found]


CONFIGS = {"1": config1, "2": config2, "4": config4, "5": config5}


def peak_host_rss() -> int:
    """The process's peak resident set so far, bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run(device="cuda", tiny: bool = False, configs=tuple(CONFIGS)) -> dict:
    """Every line of ``configs``, the peak host RSS and the card."""
    lines = [entry for c in configs for entry in CONFIGS[c](device, tiny)[0]]
    return {"lines": lines, "peak_host_rss_bytes": peak_host_rss(), "card": card_line()}


def main() -> None:
    out = run(configs=sys.argv[1:] or tuple(CONFIGS))
    for entry in out.pop("lines"):
        print(json.dumps(entry))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
