"""Multi-process global mesh: one search spanning several processes, on
``torch.distributed``.

Port of ``tensortruth_tpu/parallel/distributed.py``. Every process launches
the same program, joins one process group (:func:`init_process`) and holds
its own slots of one global mesh (:func:`global_mesh`): the local mesh of its
cards, with ``None`` in the slots other processes own. Each process loads
and places only its own rows (:func:`my_row_range`,
:func:`place_global_corpus`) or IVF clusters (:func:`my_cluster_range`,
:func:`place_global_ivf`); the row and cluster arithmetic is the
reference's for the same world size and shard count.

A collective search (:class:`GlobalMeshSearch`, :class:`GlobalMeshIVF`):

* the processes first all-gather one (holds the batch, batch size) pair
  each, so the query batch is broadcast from whichever process holds it, never
  assumed to be rank 0 (the reference's ``is_source`` rule);
* every process runs B1 / B2 / B4 on the shards it holds, as in
  ``parallel/sharded_topk.py`` and ``ops/ivf.py``;
* the (B, k) candidates cross processes with ``all_gather_into_tensor`` and
  every process merges them shard-major, so all return the same result.

The backend is the caller's choice (``init_process(backend=...)``): ``nccl``
when each process owns its own card, ``gloo`` on the CPU and when processes
share one card (NCCL refuses two ranks on one card). Over gloo the query
batch and the candidates move through host memory; over nccl they stay on
the card. The choice follows the backend, nothing else.
"""

from __future__ import annotations

import datetime
import logging

import numpy as np
import torch
import torch.distributed as dist

from tensortruth_tpu_torch.ops.ivf import ShardedIVF, host_tensor, positions_to_rows, shard_ivf_candidates, shard_parts
from tensortruth_tpu_torch.ops.topk import merge_candidates, quantize_corpus
from tensortruth_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, canonical, local_devices
from tensortruth_tpu_torch.parallel.sharded_topk import (
    ShardedCorpus,
    _per_shard_rows,
    _rows_of,
    gather_candidates,
    place,
    shard_candidates,
)

logger = logging.getLogger(__name__)


def init_process(
    coordinator_address: str, num_processes: int, process_id: int, *, backend: str, timeout_s: float = 60.0
) -> None:
    """Join the process group (call once per process, before any
    collective). ``coordinator_address`` is ``host:port`` of rank 0's
    rendezvous (what ``MASTER_ADDR`` / ``MASTER_PORT`` carry); a rank that
    does not meet the others within ``timeout_s`` raises."""
    host, port = coordinator_address.rsplit(":", 1)
    dist.init_process_group(
        backend, init_method=f"tcp://{host}:{port}", world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    logger.info("joined process group: rank %d of %d, backend %s", process_id, num_processes, backend)


def global_mesh(n_data: int = 1, devices: list | None = None) -> Mesh:
    """The mesh over every process's slots, this process's filled with
    ``devices`` (default: its CUDA cards). Slots are ordered by process, so
    with ``n_data=1`` each process holds a contiguous block of shards. Every
    process must bring the same number of devices."""
    devices = [canonical(d) for d in (devices if devices is not None else local_devices())]
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(devices))
    if any(c != len(devices) for c in counts):
        raise ValueError(f"global mesh needs the same device count on every process, got {counts}")
    return process_mesh(dist.get_world_size(), dist.get_rank(), devices, n_data)


def process_mesh(world: int, rank: int, devices: list, n_data: int = 1) -> Mesh:
    """Process ``rank``'s view of the global mesh over ``world`` processes
    of ``len(devices)`` slots each: the global slots in process order,
    filled row by row (the reference's ``make_mesh(devices=jax.devices())``
    over a multi-process runtime), ``None`` where another process owns the
    slot."""
    per = len(devices)
    if not per or (per * world) % n_data:
        raise ValueError(f"{world} processes x {per} devices do not split into {n_data} data rows")
    n_shards = per * world // n_data
    owner = [[(r * n_shards + s) // per for s in range(n_shards)] for r in range(n_data)]
    grid = [[devices[(r * n_shards + s) % per] if owner[r][s] == rank else None for s in range(n_shards)]
            for r in range(n_data)]
    return Mesh(grid, owner, rank)


def owned_shards(mesh: Mesh, rank: int | None = None) -> list[int]:
    """The shards process ``rank`` (default: this one) holds a slot of."""
    rank = mesh.rank if rank is None else rank
    return [s for s in range(mesh.shape[SHARD_AXIS]) if any(row[s] == rank for row in mesh.ranks)]


def my_row_range(mesh: Mesh, n_total: int, tile_n: int = 2048) -> tuple[int, int, int]:
    """(start, stop, n_pad): the global corpus rows THIS process must load.
    ``stop`` may exceed ``n_total``: the tail is zero-filled at placement."""
    p = mesh.shape[SHARD_AXIS]
    per_shard = _per_shard_rows(n_total, p, tile_n)
    mine = owned_shards(mesh)
    return min(mine) * per_shard, (max(mine) + 1) * per_shard, per_shard * p


def my_cluster_range(mesh: Mesh, n_clusters: int) -> tuple[int, int, int]:
    """(start, stop, nc_pad): the IVF clusters THIS process must load;
    clusters pad to a multiple of the shard count."""
    p = mesh.shape[SHARD_AXIS]
    nc_pad = -(-n_clusters // p) * p
    cpl = nc_pad // p
    mine = owned_shards(mesh)
    return min(mine) * cpl, (max(mine) + 1) * cpl, nc_pad


def _local_block(local_rows, start: int, stop: int, n_total: int, what: str) -> torch.Tensor:
    rows = _rows_of(local_rows)
    want = min(stop, n_total) - min(start, n_total)
    if rows.shape[0] != want:
        raise ValueError(f"process owns global {what} [{start}, {stop}) of {n_total}: "
                         f"expected {want} local {what}, got {rows.shape[0]}")
    return rows


def place_global_corpus(
    local_rows, *, mesh: Mesh, n_total: int, dtype: str = "float32", tile_n: int = 2048
) -> ShardedCorpus:
    """This process's shards of the global row-sharded (n_pad, D) corpus.
    ``local_rows`` is exactly rows ``[start, min(stop, n_total))`` of
    :func:`my_row_range`; no process holds more than its own block."""
    start, stop, _ = my_row_range(mesh, n_total, tile_n)
    rows = _local_block(local_rows, start, stop, n_total, "rows")
    per_shard = _per_shard_rows(n_total, mesh.shape[SHARD_AXIS], tile_n)
    parts = {}
    for s in owned_shards(mesh):
        buf = torch.zeros((per_shard, rows.shape[1]), dtype=getattr(torch, dtype))
        piece = rows[s * per_shard - start : (s + 1) * per_shard - start]
        buf[: piece.shape[0]] = piece
        parts[s] = place(buf, mesh.shard_devices(s))
    return ShardedCorpus(mesh, per_shard, parts)


def place_global_corpus_int8(local_rows, *, mesh: Mesh, n_total: int, tile_n: int = 2048) -> ShardedCorpus:
    """int8 variant: each process quantizes its own rows (per-row scales
    are row-local), exactly as the single-process ``shard_corpus_int8``;
    padding rows get scale 0."""
    start, stop, _ = my_row_range(mesh, n_total, tile_n)
    rows = _local_block(local_rows, start, stop, n_total, "rows").to(torch.float32)
    per_shard = _per_shard_rows(n_total, mesh.shape[SHARD_AXIS], tile_n)
    parts, scales = {}, {}
    for s in owned_shards(mesh):
        buf = np.zeros((per_shard, rows.shape[1]), np.float32)
        piece = rows[s * per_shard - start : (s + 1) * per_shard - start].numpy()
        buf[: piece.shape[0]] = piece
        q, sc = quantize_corpus(buf)
        sc[piece.shape[0]:] = 0.0
        devices = mesh.shard_devices(s)
        parts[s], scales[s] = place(torch.from_numpy(q), devices), place(torch.from_numpy(sc), devices)
    return ShardedCorpus(mesh, per_shard, parts, scales)


def place_global_ivf(
    *,
    mesh: Mesh,
    n_clusters: int,
    n_actual: int,
    local_centroids,
    local_blocks,
    local_valid,
    local_scales=None,
    row_map: np.ndarray | None = None,
) -> ShardedIVF:
    """This process's shards of a cluster-sharded IVF index. Each process
    passes ONLY its :func:`my_cluster_range` slice of the cluster-major
    arrays. ``row_map`` maps candidate positions back to rows: the full
    (n_clusters, rpc) table on processes that hydrate results, None
    elsewhere (their rows come back -1)."""
    start, stop, nc_pad = my_cluster_range(mesh, n_clusters)
    blocks_in = torch.as_tensor(local_blocks)
    want = min(stop, n_clusters) - min(start, n_clusters)
    if blocks_in.shape[0] != want:
        raise ValueError(f"process owns clusters [{start}, {stop}) of {n_clusters}: "
                         f"expected {want} local clusters, got {blocks_in.shape[0]}")
    rpc, dim = blocks_in.shape[1], blocks_in.shape[2]
    quantized = local_scales is not None
    my_nc = stop - start
    blocks = blocks_in.new_zeros((my_nc, rpc, dim))
    blocks[:want] = blocks_in
    cent = torch.zeros((my_nc, dim), dtype=torch.bfloat16 if quantized else blocks.dtype)
    cent[:want] = torch.as_tensor(local_centroids).to(cent.dtype)
    valid = torch.zeros((my_nc, rpc), dtype=torch.int32)
    valid[:want] = torch.as_tensor(local_valid)
    scales = None
    if quantized:
        scales = torch.ones((my_nc, rpc), dtype=torch.float32)
        scales[:want] = torch.as_tensor(local_scales)
    rm = np.full((nc_pad, rpc), -1, np.int64)
    if row_map is not None:
        rm[:n_clusters] = row_map
    cpl = nc_pad // mesh.shape[SHARD_AXIS]
    return ShardedIVF(
        mesh=mesh, cpl=cpl, parts=shard_parts(mesh, cpl, cent, blocks, valid, scales, owned_shards(mesh), start // cpl),
        row_map=rm, n_actual=n_actual, n_clusters_actual=n_clusters, quantized=quantized,
    )


def _comm_device(mesh: Mesh) -> torch.device:
    """Where collective tensors live: host memory over gloo, the lead card
    over nccl."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else mesh.lead


def broadcast_queries(mesh: Mesh, q, batch: int | None, dim: int) -> torch.Tensor:
    """The (B, dim) f32 query batch on every process, broadcast from the
    one process that passed it (the others pass None and ``batch``)."""
    comm = _comm_device(mesh)
    mine = torch.tensor([q is not None, q.shape[0] if q is not None else -1 if batch is None else batch],
                        dtype=torch.int64, device=comm)
    every = torch.empty(2 * dist.get_world_size(), dtype=torch.int64, device=comm)
    dist.all_gather_into_tensor(every, mine)
    pairs = every.view(-1, 2).tolist()
    sources = [r for r, (held, _) in enumerate(pairs) if held]
    if len(sources) != 1:
        raise ValueError(f"exactly one process must pass the query batch, got ranks {sources}")
    b = pairs[sources[0]][1]
    if any(n != b for held, n in pairs if not held):
        raise ValueError(f"non-serving processes must pass batch={b}, got {[n for _, n in pairs]} (-1: none)")
    buf = (host_tensor(q) if not torch.is_tensor(q) else q.float()).to(comm) if q is not None else \
        torch.empty((b, dim), dtype=torch.float32, device=comm)
    dist.broadcast(buf, sources[0])
    return buf


def merge_global(mesh: Mesh, cand_v: torch.Tensor, cand_i: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Every process's shard-major candidates (its own held shards) gathered
    across processes, each shard taken from its first owner, and merged
    shard-major: the same (scores, ids) on every process, as numpy."""
    world = dist.get_world_size()
    owned = [owned_shards(mesh, r) for r in range(world)]
    if any(len(o) != len(owned[0]) for o in owned):
        raise ValueError(f"every process must hold the same number of shards, got {owned}")
    comm = _comm_device(mesh)
    b, width = cand_v.shape
    k_local = width // len(owned[0])
    gathered = []
    for t in (cand_v, cand_i):
        out = torch.empty((world * b, width), dtype=t.dtype, device=comm)
        dist.all_gather_into_tensor(out, t.to(comm).contiguous())
        gathered.append(out.view(world, b, len(owned[0]), k_local))
    order = []
    for s in range(mesh.shape[SHARD_AXIS]):
        r = next(r for r in range(world) if s in owned[r])
        order.append((r, owned[r].index(s)))
    vals, ids = (torch.cat([g[r, :, j] for r, j in order], dim=1) for g in gathered)
    vals, ids = merge_candidates(vals, ids, k)
    return vals.cpu().numpy(), ids.cpu().numpy()


class GlobalMeshSearch:
    """Collective dense top-k over the global mesh.

    Every process builds this with ITS local rows and then calls
    :meth:`search` in lockstep: the serving process passes the real query
    batch, the others pass None and ``batch``. Every process gets the same
    (scores, global ids)."""

    def __init__(
        self,
        local_rows,
        *,
        n_total: int,
        mesh: Mesh | None = None,
        dtype: str = "float32",
        use_fused: bool = False,
        tile_n: int = 2048,
    ):
        self.mesh = mesh if mesh is not None else global_mesh()
        self.n_total = n_total
        self.use_fused = use_fused
        self.tile_n = tile_n
        if dtype == "int8":
            self.emb = place_global_corpus_int8(local_rows, mesh=self.mesh, n_total=n_total, tile_n=tile_n)
        else:
            self.emb = place_global_corpus(local_rows, mesh=self.mesh, n_total=n_total, dtype=dtype, tile_n=tile_n)
        self.dim = self.emb.shape[1]

    def search(self, q, k: int, batch: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(scores (B, k) f32, global ids (B, k) int32) on EVERY process."""
        q = broadcast_queries(self.mesh, q, batch, self.dim)
        # the corpus dtype; over int8, B2 takes a bf16 query and the exact
        # path dequantises in f32, as the reference's does
        int8 = self.emb.dtype == torch.int8
        q = q.to((torch.bfloat16 if self.use_fused else torch.float32) if int8 else self.emb.dtype)
        with torch.inference_mode():
            cands = shard_candidates(q, self.emb, k=k, n_actual=self.n_total, use_fused=self.use_fused,
                                     tile_n=self.tile_n)
            cand_v, cand_i = gather_candidates(cands, q.shape[0], min(k, self.emb.per_shard), self.mesh.lead)
        return merge_global(self.mesh, cand_v, cand_i, k)


class GlobalMeshIVF:
    """Collective IVF search over the global mesh: cluster blocks shard over
    every process's devices, each shard probes the top-``nprobe`` of its
    own clusters, and the candidates merge across processes as in
    :class:`GlobalMeshSearch`."""

    def __init__(self, sharded_ivf: ShardedIVF):
        self.sidx = sharded_ivf
        first = next(iter(next(iter(sharded_ivf.parts.values())).values()))
        self.dim = first[1].shape[2]

    def search(self, q, k: int, nprobe: int = 8, batch: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(scores (B, k) f32, original rows (B, k), -1 pads) on EVERY
        process (rows are -1 where ``place_global_ivf`` had no row map)."""
        sidx = self.sidx
        q = broadcast_queries(sidx.mesh, q, batch, self.dim)
        q = q.to(torch.bfloat16 if sidx.quantized else sidx.dtype)
        lead = sidx.mesh.lead
        with torch.inference_mode():
            cands = shard_ivf_candidates(sidx, q, k, nprobe)
            cand_v = torch.cat([v.to(lead) for v, _ in cands], dim=1)
            cand_p = torch.cat([p.to(lead) for _, p in cands], dim=1)
        vals, pos = merge_global(sidx.mesh, cand_v, cand_p, k)
        return vals, positions_to_rows(sidx, vals, pos)
