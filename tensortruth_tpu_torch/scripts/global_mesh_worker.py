"""One process of a global mesh: load this process's rows, place them, search
in lockstep with the other processes, write a JSON report.

    python -m tensortruth_tpu_torch.scripts.global_mesh_worker \\
        --coordinator 127.0.0.1:PORT --world 2 --rank R --backend gloo \\
        --device cuda --local-shards 2 --index DIR [--index DIR ...] \\
        --queries Q.npy --k 20 --dtype bfloat16 --fused --out REPORT.json

The corpus is the stack of the index directories' leaf matrices, in order
(the engine's stack). Each process reads only rows ``[start, stop)`` of
``my_row_range`` from them and places them through ``GlobalMeshSearch``:
first in ``--dtype``, then int8. With ``--ivf-clusters N`` every process also
builds the same IVF index over the whole stack (same rows, same seed, blocks
in ``--dtype``) and places only its ``my_cluster_range`` clusters through
``GlobalMeshIVF``, probing every cluster. The last rank serves: it passes the queries, the
others pass None and the batch size. The report holds the row and cluster
ranges, each search's (scores, ids), the kernel launches counted while the
searches ran, and seconds per step.

:func:`run_world` starts a whole world of these processes on 127.0.0.1 and
returns their reports.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tensortruth_tpu_torch.index.store import VectorIndex
from tensortruth_tpu_torch.ops.ivf import build_ivf, probe_scores
from tensortruth_tpu_torch.ops.topk import fused_topk, fused_topk_int8
from tensortruth_tpu_torch.parallel.distributed import (
    GlobalMeshIVF,
    GlobalMeshSearch,
    global_mesh,
    init_process,
    my_cluster_range,
    my_row_range,
    place_global_ivf,
)

ROOT = Path(__file__).resolve().parents[2]


def run_world(args_per_rank: list[list[str]], work: Path, timeout: float, env: dict | None = None) -> list[dict]:
    """Run one worker per entry of ``args_per_rank`` (this script's options
    less ``--coordinator``, ``--world``, ``--rank`` and ``--out``) as one
    world on a free port of 127.0.0.1, from the checkout's root, with
    ``env`` added to the environment. Waits at most ``timeout`` seconds in
    all and kills every worker still running then. Raises with a worker's
    log (``work/rank{r}.log``) when one failed or the time ran out; returns
    the reports, by rank."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    world = len(args_per_rank)
    logs = [work / f"rank{r}.log" for r in range(world)]
    outs = [work / f"rank{r}.json" for r in range(world)]
    procs = []
    try:
        for r, args in enumerate(args_per_rank):
            with logs[r].open("w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tensortruth_tpu_torch.scripts.global_mesh_worker", "--coordinator",
                     f"127.0.0.1:{port}", "--world", str(world), "--rank", str(r), "--out", str(outs[r]), *args],
                    cwd=ROOT, env={**os.environ, **(env or {})}, stdout=log, stderr=subprocess.STDOUT,
                ))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"the world of {world} did not finish within {timeout} s (rendezvous or a collective "
                           f"hung); rank 0's log:\n{logs[0].read_text()[-4000:]}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{logs[r].read_text()[-4000:]}")
    return [json.loads(o.read_text()) for o in outs]


def stack_pieces(index_dirs: list[str]):
    """(total rows, zero-arg iterator of row-contiguous f32 pieces) of the
    indexes' leaf matrices, stacked in order."""
    indexes = [VectorIndex.load(d) for d in index_dirs]

    def pieces():
        for idx in indexes:
            yield from idx.iter_matrix_pieces()

    return sum(idx.n_alive for idx in indexes), pieces


def rows_between(pieces, start: int, stop: int) -> np.ndarray:
    """Rows ``[start, stop)`` of the stack, reading only the pieces that
    hold them."""
    out, base = [], 0
    for piece in pieces():
        lo, hi = max(start, base), min(stop, base + piece.shape[0])
        if hi > lo:
            out.append(np.asarray(piece[lo - base : hi - base], np.float32))
        base += piece.shape[0]
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", required=True)
    ap.add_argument("--local-shards", type=int, required=True)
    ap.add_argument("--index", action="append", required=True)
    ap.add_argument("--queries", required=True)
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--tile-n", type=int, default=2048)
    ap.add_argument("--ivf-clusters", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=60.0, help="seconds: the rendezvous and each collective; "
                    "after four times this the process prints every thread's stack and exits")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    faulthandler.dump_traceback_later(4 * args.timeout, exit=True)
    if args.device.startswith("cuda"):
        torch.cuda.set_device(torch.device(args.device))  # nccl's collectives run on the current card
    seconds = {}
    t0 = time.perf_counter()
    init_process(args.coordinator, args.world, args.rank, backend=args.backend, timeout_s=args.timeout)
    mesh = global_mesh(devices=[args.device] * args.local_shards)
    seconds["join"] = time.perf_counter() - t0
    n_total, pieces = stack_pieces(args.index)
    start, stop, n_pad = my_row_range(mesh, n_total, args.tile_n)
    t0 = time.perf_counter()
    local = rows_between(pieces, start, min(stop, n_total))
    seconds["read"] = time.perf_counter() - t0
    serving = args.rank == args.world - 1
    queries = np.load(args.queries) if serving else None
    batch = np.load(args.queries, mmap_mode="r").shape[0]
    report = {"rank": args.rank, "row_range": [start, stop, n_pad], "n_total": n_total, "searches": {}}
    fused_topk.launches = fused_topk_int8.launches = probe_scores.launches = 0

    def record(name, fn, search):
        t = time.perf_counter()
        engine = fn()
        seconds[f"place_{name}"] = time.perf_counter() - t
        t = time.perf_counter()
        scores, ids = search(engine)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds[f"search_{name}"] = time.perf_counter() - t
        report["searches"][name] = {"scores": scores.tolist(), "ids": ids.tolist()}

    def flat(dtype):
        return lambda: GlobalMeshSearch(local, n_total=n_total, mesh=mesh, dtype=dtype, use_fused=args.fused,
                                        tile_n=args.tile_n)

    for dtype in (args.dtype, "int8"):
        record(dtype, flat(dtype), lambda e: e.search(queries, args.k, batch=batch))
    if args.ivf_clusters:
        t0 = time.perf_counter()
        ivf = build_ivf(pieces, n_clusters=args.ivf_clusters, n_rows=n_total, dim=local.shape[1], seed=3,
                        block_dtype=getattr(torch, args.dtype), device=args.device, device_blocks=False)
        seconds["build_ivf"] = time.perf_counter() - t0
        c0, c1, nc_pad = my_cluster_range(mesh, args.ivf_clusters)
        lo, hi = min(c0, args.ivf_clusters), min(c1, args.ivf_clusters)
        report["cluster_range"] = [c0, c1, nc_pad]

        def place():
            return GlobalMeshIVF(place_global_ivf(
                mesh=mesh, n_clusters=args.ivf_clusters, n_actual=n_total, local_centroids=ivf.centroids[lo:hi],
                local_blocks=ivf.blocks[lo:hi], local_valid=ivf.valid[lo:hi].cpu(), row_map=ivf.row_map,
            ))

        record("ivf", place, lambda e: e.search(queries, args.k, nprobe=args.ivf_clusters, batch=batch))
    report["launches"] = {"fused_topk": fused_topk.launches, "fused_topk_int8": fused_topk_int8.launches,
                          "ivf_probe": probe_scores.launches}
    report["seconds"] = seconds
    Path(args.out).write_text(json.dumps(report))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
