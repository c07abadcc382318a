"""The mesh tier on the CUDA cards of one machine: each sharded search and DP
forward against its twin with every shard on one card, both timed.

    python -m tensortruth_tpu_torch.scripts.measure_mesh   # every card of the machine

With n cards:

1. A corpus of about ROWS unit rows (n shards of whole 2048-row tiles; bf16,
   and int8 through ``quantize_corpus``, made from the seed), placed one
   shard per card and all on card 0. The sharded top-k of 32 queries runs
   B1 / B2 once per shard; each layout is held against the same sharding
   through the plain versions (ids may differ only where two scores are
   within TOPK_TOL), and the two layouts must give the same ids. Timed by
   the host's clock over ITERS searches, every card synchronised at the end
   (CUDA events time one card), REPEATS times; the host's time to issue
   ITERS searches alone, without waiting for a card; and TRACE_SEARCHES
   searches under ``torch.profiler``: per search, the host's span and, per
   card, when its kernels ran, from the search's start.
2. BGE-M3 at full width (random weights) as a DP embedder over n slots, one
   per card and all on card 0, encoding 2048 leaves of 248 words
   (``measure_build.synth_chunks``) DP_REPEATS times; the two must agree
   within DP_TOL.
3. An NCCL world of n processes, one card each
   (``scripts/global_mesh_worker.py``, one shard each), over an index of
   INDEX_ROWS rows written here: its bf16 and int8 top-20 on every rank
   must equal this process's sharded search over the same rows, n shards on
   the n cards.

Prints the card's name and power limit, then one JSON line with every
number. Needs no network; its scratch files live in a directory inside the
checkout that is removed at exit.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tensortruth_tpu_torch.index import HierarchyStore, Node, VectorIndex
from tensortruth_tpu_torch.models.embedder import Embedder
from tensortruth_tpu_torch.models.xlmr import BGE_M3_CONFIG
from tensortruth_tpu_torch.ops.topk import check_topk_agrees, quantize_corpus
from tensortruth_tpu_torch.parallel.mesh import local_devices, make_mesh
from tensortruth_tpu_torch.parallel.sharded_topk import ShardedCorpus, shard_corpus, shard_corpus_int8, sharded_topk
from tensortruth_tpu_torch.scripts.global_mesh_worker import run_world
from tensortruth_tpu_torch.scripts.measure_build import synth_chunks
from tensortruth_tpu_torch.tokenization import load_tokenizer

ROOT = Path(__file__).resolve().parents[2]
SEED = 0
ROWS = 2_097_152
INDEX_ROWS = 262_144
DIM = 1024
QUERIES = 32
ITERS = 20
REPEATS = 5
TRACE_SEARCHES = 5
DP_REPEATS = 3
TOPK_TOL = 1e-4
# One model's forwards over the same rows, on cards of one kind: a few bf16
# steps of one component of a unit-norm 1024-wide embedding (about 0.03).
DP_TOL = 1e-3
WORKER_TIMEOUT_S = 120


def synchronize_all(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def host_ms(fn, devices, iters: int = ITERS) -> float:
    """Host milliseconds per call of ``fn``, after a warm-up, with every
    card synchronised before and after the timed calls."""
    fn()
    synchronize_all(devices)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize_all(devices)
    return (time.perf_counter() - t) * 1e3 / iters


def issue_ms(fn, devices, iters: int = ITERS) -> float:
    """Host milliseconds per call of ``fn`` to issue it alone: the clock
    stops before the cards are waited for."""
    fn()
    synchronize_all(devices)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / iters
    synchronize_all(devices)
    return ms


def union_ms(spans: list[tuple[float, float]]) -> float:
    """Milliseconds covered by at least one of the (start, end) spans, in us."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def trace_search(fn, devices) -> list[dict]:
    """``fn`` under ``torch.profiler``, TRACE_SEARCHES times after a
    warm-up, each search waited for before the next (the profiler's first
    search is dropped: its trace can miss a kernel). Per search: the host's
    span (profiler on), when the last kernel ended, and per card its
    kernels' busy time, when its first started and its last ended, and when
    its B1 / B2 ran (ms from the search's start); ``overlap``: B1 / B2's summed kernel time over
    the time some card ran one (1 when the cards take turns, n when all n
    run at once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    synchronize_all(devices)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_SEARCHES + 1):
            with record_function("sharded search"):
                fn()
            synchronize_all(devices)
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "sharded search" and e.device_type == DeviceType.CPU)
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != "sharded search"]
    out = []
    for i, (t0, t1) in enumerate(spans):
        if i == 0:
            continue
        t_next = spans[i + 1][0] if i + 1 < len(spans) else float("inf")
        mine = [e for e in device if t0 <= e.time_range.start < t_next]
        topk = [(e.time_range.start, e.time_range.end) for e in mine if "topk_stream_kernel" in e.name]
        if not topk:
            raise RuntimeError("the trace of a sharded search holds no B1 / B2 kernel")
        cards = {}
        for e in mine:
            cards.setdefault(e.device_index, []).append(e)
        out.append({
            "host_ms": (t1 - t0) / 1e3,
            "end_ms": (max(e.time_range.end for e in mine) - t0) / 1e3,
            "overlap": sum(b - a for a, b in topk) / 1e3 / union_ms(topk),
            "cards": {str(d): {"kernels": len(es), "busy_ms": sum(e.time_range.elapsed_us() for e in es) / 1e3,
                               "first_start_ms": (min(e.time_range.start for e in es) - t0) / 1e3,
                               "last_end_ms": (max(e.time_range.end for e in es) - t0) / 1e3,
                               "topk_ms": [[(e.time_range.start - t0) / 1e3, (e.time_range.end - t0) / 1e3]
                                           for e in es if "topk_stream_kernel" in e.name]}
                      for d, es in sorted(cards.items())},
        })
    return out


def unit_rows(n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda:0").manual_seed(seed)
    x = torch.randn((n, DIM), generator=gen, device="cuda:0")
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def layouts(cards: list[torch.device]) -> dict:
    """The two placements of n shards: one per card, and all on card 0."""
    return {"one per card": make_mesh(n_shards=len(cards), devices=cards),
            "all on card 0": make_mesh(n_shards=len(cards), devices=[cards[0]] * len(cards))}


def spread(values: list[float]) -> dict:
    return {"runs": values, "median": float(np.median(values)), "min": min(values), "max": max(values)}


def measure_search(cards: list[torch.device]) -> dict:
    n = len(cards)
    per_shard = -(-ROWS // n // 2048) * 2048  # whole B1 tiles; every row valid
    q = unit_rows(QUERIES, SEED + 1).to(torch.bfloat16)
    out = {}
    for dtype in ("bfloat16", "int8"):
        shards = []
        for s in range(n):
            rows = unit_rows(per_shard, SEED + 10 + s)
            if dtype == "int8":
                shards.append([torch.from_numpy(a) for a in quantize_corpus(rows.cpu().numpy())])
            else:
                shards.append((rows.to(torch.bfloat16).cpu(), None))
            del rows
        results = {}
        for name, mesh in layouts(cards).items():
            parts = {s: {mesh.grid[0][s]: shards[s][0].to(mesh.grid[0][s])} for s in range(n)}
            scales = ({s: {mesh.grid[0][s]: shards[s][1].to(mesh.grid[0][s])} for s in range(n)}
                      if dtype == "int8" else None)
            corpus = ShardedCorpus(mesh, per_shard, parts, scales)
            kw = dict(k=20, n_actual=per_shard * n, use_fused=True)
            got = sharded_topk(q, corpus, **kw)
            err, swaps = check_topk_agrees(f"{dtype} {name}", got, sharded_topk(q, corpus, plain=True, **kw), TOPK_TOL)

            def search():
                return sharded_topk(q, corpus, **kw)

            results[name] = {"ms": spread([host_ms(search, cards) for _ in range(REPEATS)]),
                             "issue_ms": spread([issue_ms(search, cards) for _ in range(REPEATS)]),
                             "plain_ms": host_ms(lambda: sharded_topk(q, corpus, plain=True, **kw), cards, iters=3),
                             "trace": trace_search(search, cards),
                             "max_abs_err": err, "index_swaps": swaps, "ids": got[1].cpu()}
            del corpus, parts, scales
        a, b = (results[name].pop("ids") for name in layouts(cards))
        if not torch.equal(a, b):
            raise RuntimeError(f"{dtype}: the two placements returned different top-20 ids")
        out[dtype] = results
        del shards
        torch.cuda.empty_cache()
    return out


def measure_dp_embed(cards: list[torch.device]) -> dict:
    texts = synth_chunks(2048)
    tok = load_tokenizer()
    embedders = {name: Embedder.random_init(BGE_M3_CONFIG, tok, cards[0], mesh=mesh)
                 for name, mesh in layouts(cards).items()}
    out, embs = {}, {}
    for name, emb in embedders.items():
        emb.encode(texts[:256])  # warm-up
        seconds = []
        for _ in range(DP_REPEATS):
            synchronize_all(cards)
            t = time.perf_counter()
            embs[name] = emb.encode(texts)
            seconds.append(time.perf_counter() - t)
        out[name] = {"seconds": spread(seconds), "chunks_per_s": len(texts) / float(np.median(seconds))}
    diff = float(np.abs(embs["one per card"] - embs["all on card 0"]).max())
    if diff > DP_TOL:
        raise RuntimeError(f"DP embeddings differ between the placements by {diff}")
    out["max_abs_diff"] = diff
    return out


def write_index(path: Path) -> np.ndarray:
    rows = unit_rows(INDEX_ROWS, SEED + 2).cpu().numpy()
    store = HierarchyStore()
    store.add_all([Node(node_id=f"m{i}", text=f"row {i}", level=0, doc_id="mesh") for i in range(INDEX_ROWS)])
    store.finalize_leaves()
    VectorIndex(rows, [f"m{i}" for i in range(INDEX_ROWS)], store, {"embedding_model": "BAAI/bge-m3"}).save(path)
    return rows


def measure_nccl_world(cards: list[torch.device], work: Path) -> dict:
    n = len(cards)
    t0 = time.perf_counter()
    rows = write_index(work / "index")
    write_s = time.perf_counter() - t0
    q = unit_rows(8, SEED + 3).cpu().numpy()
    np.save(work / "q.npy", q)
    mesh = make_mesh(n_shards=n, devices=cards)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    want = {"bfloat16": sharded_topk(qt, shard_corpus(torch.from_numpy(rows).to(torch.bfloat16), mesh, 2048)[0],
                                     k=20, n_actual=INDEX_ROWS, use_fused=True),
            "int8": sharded_topk(qt, shard_corpus_int8(rows, mesh, 2048)[0], k=20, n_actual=INDEX_ROWS,
                                 use_fused=True)}
    args = [["--backend", "nccl", "--device", str(card), "--local-shards", "1", "--index", str(work / "index"),
             "--queries", str(work / "q.npy"), "--k", "20", "--dtype", "bfloat16", "--fused",
             "--timeout", str(WORKER_TIMEOUT_S / 4)] for card in cards]
    t0 = time.perf_counter()
    reports = run_world(args, work, timeout=WORKER_TIMEOUT_S + 30)
    wall_s = time.perf_counter() - t0
    for dtype, (vals, ids) in want.items():
        for rep in reports:
            if rep["searches"][dtype]["ids"] != ids.cpu().tolist():
                raise RuntimeError(f"NCCL rank {rep['rank']} {dtype}: top-20 differs from the one-process search")
    return {"ranks": n, "index_write_s": write_s, "wall_s": wall_s, "seconds": [rep["seconds"] for rep in reports],
            "launches": [rep["launches"] for rep in reports]}


def main() -> None:
    cards = local_devices()
    if not cards:
        raise SystemExit("measure_mesh needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"cards: {len(cards)}; {card}", flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    work = Path(tempfile.mkdtemp(prefix=".measure_mesh_", dir=ROOT))
    try:
        result = {"cards": [torch.cuda.get_device_name(c) for c in cards], "nvidia_smi": card}
        with torch.inference_mode():
            result["search"] = measure_search(cards)
            print(f"search: {json.dumps(result['search'])}", flush=True)
            result["dp_embed"] = measure_dp_embed(cards)
            print(f"DP embed: {json.dumps(result['dp_embed'])}", flush=True)
        result["nccl_world"] = measure_nccl_world(cards, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
