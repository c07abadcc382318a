"""IVF coarse partitioning: the capacity tier of retrieval (kernel B4).

Port of ``tensortruth_tpu/ops/ivf.py``, with its cluster-sharded tier
(:class:`ShardedIVF`). Same layout and contract:

* **Build:** spherical k-means on a row sample, one streaming top-2
  assignment pass on the device, then rows packed cluster-major into a
  padded (n_clusters, rows_per_cluster, D) block tensor in the storage dtype
  (bf16, or int8 with per-row scales), overflow spilling to the second-best
  cluster and then capacity-aware. ``row_map`` carries padded positions to
  original rows (-1 for padding).
* **Query:** (B, n_clusters) centroid scores -> top-``nprobe`` clusters ->
  probe scores (B, nprobe, rows_per_cluster) -> one stable top-k over the
  probed positions ``probe * rpc + slot``.
* **Sharded:** the clusters pad to a multiple of the mesh's shard count and
  each shard holds its ``cpl`` clusters; per shard the centroids are scored,
  padded clusters masked, the top-``min(nprobe, cpl)`` of the shard's own
  clusters probed through B4 (the int8 grouping over those ``cpl``
  clusters), and the local top-k taken at global positions; the candidates
  merge shard-major on the lead device as in ``parallel/sharded_topk.py``.

Dispatch: :func:`probe_scores` on CUDA tensors launches the hand-written
kernels (``csrc/ivf_probe.cu``) or raises; CPU tensors take the plain
version, :func:`probe_scores_plain`, which scores one probe column at a time
like the reference's ``lax.map`` fallback. Over int8 blocks the kernel first
groups the (query, probe) pairs by cluster on the device
(:func:`group_probes`, plain version :func:`group_probes_plain`), so that
each probed cluster is read once for all the pairs that name it.

Deliberate difference: the k-means seed rows come from a ``torch.Generator``
seeded by ``seed`` (the reference draws them with ``jax.random.choice``), so
one seed clusters differently in the two packages. :func:`_kmeans_fit` takes
``init_idx`` and :func:`ivf_index_from_arrays` carries a built index across,
which is how the two are held to each other.

``PROBE_TILE``, the 1.5x / 95th-percentile / 4x sizing and the engine's
cluster and probe counts are the reference's, sized on a TPU and not yet
re-measured on the H100.
"""

from __future__ import annotations

import logging
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from tensortruth_tpu_torch import _build
from tensortruth_tpu_torch.ops.matmul import bmm_f32, mm_f32
from tensortruth_tpu_torch.ops.topk import NEG_INF, _sorted_topk, merge_candidates

logger = logging.getLogger(__name__)

PROBE_TILE = 1024  # the reference's rows per TPU grid step; the CUDA kernels tile by 128 and 64
_MAX_D = 8192  # the bf16 kernel stages one f32 query in shared memory
_MAX_D_INT8 = 2048  # the int8 kernel stages 32 bf16 queries in shared memory
CHUNK = 32  # (query, probe) pairs per group of the int8 kernel: wgmma's N


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A float32 host array (possibly a read-only mmap) as a torch tensor,
    without a copy; it is only read from."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.asarray(arr, dtype=np.float32))


# -- kernel B4 -----------------------------------------------------------------


def probe_scores_plain(
    probe: torch.Tensor,
    q: torch.Tensor,
    blocks: torch.Tensor,
    valid: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: (B, nprobe, rpc) f32 scores of
    each query against every slot of its probed clusters, times the row
    scale for int8 blocks, -inf where ``valid`` is 0. One probe column at a
    time, so no (B, nprobe, rpc, D) gather is ever made."""
    b, nprobe = probe.shape
    rpc = blocks.shape[1]
    q = q.to(torch.bfloat16 if scales is not None else blocks.dtype)
    out = torch.empty((b, nprobe, rpc), dtype=torch.float32, device=q.device)
    for p in range(nprobe):
        cid = probe[:, p].long()
        rows = blocks[cid].to(q.dtype)  # int8 -> bf16 is exact
        s = bmm_f32(rows, q[:, :, None])[:, :, 0]
        if scales is not None:
            s = s * scales[cid]
        out[:, p] = torch.where(valid[cid] > 0, s, NEG_INF)
    return out


def group_probes_plain(probe: torch.Tensor, n_clusters: int):
    """Plain version of B4's grouping of the (query, probe) pairs, on any
    device: ``(order, chunks, n_chunks)``. ``order`` (P,) int32 lists the
    pairs ``x = b * nprobe + p`` of the flattened ``probe`` by cluster
    (ascending; a stable sort, so pair order within a cluster); ``chunks``
    (P, 3) int32 holds in its first ``n_chunks`` rows (cluster, first
    position in ``order``, count) with count <= :data:`CHUNK`, each cluster's
    pairs cut into consecutive chunks; ``n_chunks`` (1,) int32. Rows of
    ``chunks`` past ``n_chunks`` are unspecified (here: 0)."""
    flat = probe.reshape(-1).long()
    n_pairs = flat.numel()
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=n_clusters).cpu()
    starts = torch.cumsum(counts, 0) - counts
    rows = [(c, int(starts[c]) + k, min(CHUNK, int(counts[c]) - k))
            for c in torch.nonzero(counts).flatten().tolist() for k in range(0, int(counts[c]), CHUNK)]
    chunks = torch.zeros((n_pairs, 3), dtype=torch.int32)
    chunks[: len(rows)] = torch.tensor(rows, dtype=torch.int32)
    n_chunks = torch.tensor([len(rows)], dtype=torch.int32)
    return order.to(torch.int32), chunks.to(probe.device), n_chunks.to(probe.device)


def group_probes_cuda(probe: torch.Tensor, n_clusters: int):
    """B4's grouping kernel on the card: same contract as
    :func:`group_probes_plain`, but the order of the pairs within a
    cluster is not fixed. Nothing is read back to the host."""
    if probe.dtype != torch.int32 or not probe.is_cuda or not probe.is_contiguous():
        raise ValueError("ivf group kernel takes a contiguous int32 probe array on a CUDA device")
    n_pairs = probe.numel()
    dev = probe.device
    scratch = torch.empty(2 * n_clusters, dtype=torch.int32, device=dev)
    order = torch.empty(n_pairs, dtype=torch.int32, device=dev)
    chunks = torch.empty((n_pairs, 3), dtype=torch.int32, device=dev)
    n_chunks = torch.empty(1, dtype=torch.int32, device=dev)
    err = _build.load().tt_ivf_group_probes(
        probe.data_ptr(), scratch.data_ptr(), order.data_ptr(), chunks.data_ptr(), n_chunks.data_ptr(),
        n_pairs, n_clusters, _build.stream_of(probe),
    )
    _build.check(err, "ivf_group_probes")
    group_probes.launches += 1
    return order, chunks, n_chunks


def group_probes(probe: torch.Tensor, n_clusters: int):
    """:func:`group_probes_cuda` on a CUDA tensor, else the plain version."""
    return (group_probes_cuda if probe.is_cuda else group_probes_plain)(probe, n_clusters)


group_probes.launches = 0  # grouping-kernel launches (CUDA path only)


def probe_scores_cuda(
    probe: torch.Tensor,
    q: torch.Tensor,
    blocks: torch.Tensor,
    valid: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kernel B4 on the card, bf16 or int8 blocks: same contract as
    :func:`probe_scores_plain`. Raises on any input the kernel does not take.
    ``probe`` must hold cluster ids in range (it does when it comes from the
    centroid top-k); the kernel does not check them."""
    quantized = scales is not None
    want = torch.int8 if quantized else torch.bfloat16
    if blocks.dtype != want or q.dtype != torch.bfloat16:
        raise TypeError(
            f"ivf_probe kernel takes bfloat16 q and {want} blocks"
            f"{' with scales' if quantized else ''}, got {q.dtype}, {blocks.dtype}"
        )
    if probe.dtype != torch.int32 or valid.dtype != torch.int32 or (quantized and scales.dtype != torch.float32):
        raise TypeError("ivf_probe kernel takes int32 probe and valid, float32 scales")
    if blocks.dim() != 3 or q.dim() != 2 or probe.dim() != 2 or probe.shape[0] != q.shape[0]:
        raise ValueError(f"ivf_probe shapes probe {tuple(probe.shape)}, q {tuple(q.shape)}, blocks {tuple(blocks.shape)}")
    n_clusters, rpc, d = blocks.shape
    b, nprobe = probe.shape
    if q.shape[1] != d or valid.shape != (n_clusters, rpc) or (quantized and scales.shape != (n_clusters, rpc)):
        raise ValueError("ivf_probe needs q (B, D), valid and scales (n_clusters, rpc) matching blocks")
    max_d = _MAX_D_INT8 if quantized else _MAX_D
    if d % 16 or d > max_d:
        raise ValueError(f"ivf_probe kernel needs D % 16 == 0 and D <= {max_d}, got {d}")
    if b > 65535 or nprobe > 65535:
        raise ValueError(f"ivf_probe kernel takes at most 65535 queries and probes, got {b}, {nprobe}")
    if quantized and n_clusters * rpc >= 2**31:
        raise ValueError(f"ivf_probe_int8 kernel takes fewer than 2^31 slots, got {n_clusters} x {rpc}")
    tensors = (probe, q, blocks, valid) + ((scales,) if quantized else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"ivf_probe kernel needs all inputs on one CUDA device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ivf_probe kernel needs contiguous inputs")
    if blocks.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("ivf_probe kernel needs 16-byte aligned q and blocks")
    out = torch.empty((b, nprobe, rpc), dtype=torch.float32, device=q.device)
    lib, stream = _build.load(), _build.stream_of(q)
    if quantized:
        order, chunks, n_chunks = group_probes_cuda(probe, n_clusters)
        err = lib.tt_ivf_probe_scores_int8(
            q.data_ptr(), blocks.data_ptr(), valid.data_ptr(), scales.data_ptr(), order.data_ptr(),
            chunks.data_ptr(), n_chunks.data_ptr(), out.data_ptr(), nprobe, n_clusters, rpc, d, stream,
        )
        _build.check(err, "ivf_probe_int8")
        probe_scores.launches_int8 += 1
    else:
        err = lib.tt_ivf_probe_scores(
            probe.data_ptr(), q.data_ptr(), blocks.data_ptr(), valid.data_ptr(), out.data_ptr(), b, nprobe, rpc, d,
            stream,
        )
        _build.check(err, "ivf_probe")
        probe_scores.launches += 1
    return out


def probe_scores(
    probe: torch.Tensor,
    q: torch.Tensor,
    blocks: torch.Tensor,
    valid: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, nprobe, rpc) probe scores. On CUDA tensors this launches kernel
    B4 (bf16 blocks, or int8 blocks with scales); on CPU tensors it runs the
    plain version."""
    on_card = any(t.is_cuda for t in (probe, q, blocks, valid) + ((scales,) if scales is not None else ()))
    return (probe_scores_cuda if on_card else probe_scores_plain)(probe, q, blocks, valid, scales)


probe_scores.launches = 0  # kernel launches over bf16 blocks (CUDA path only)
probe_scores.launches_int8 = 0  # kernel launches over int8 blocks (CUDA path only)


# -- build ---------------------------------------------------------------------


def _init_indices(n: int, n_clusters: int, seed: int) -> torch.Tensor:
    """k-means seed rows: ``n_clusters`` distinct sample rows drawn by a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=gen)[:n_clusters]


def _kmeans_fit(
    sample: torch.Tensor,
    seed: int,
    n_clusters: int,
    iters: int = 10,
    init_idx: np.ndarray | torch.Tensor | None = None,
) -> torch.Tensor:
    """Spherical k-means on normalised f32 rows (cosine = dot), on the
    sample's device: ``iters`` Lloyd steps, first-max assignment, an empty
    cluster keeps its centroid, renormalised with ``max(norm, 1e-9)``.
    ``init_idx`` (the seed rows) defaults to :func:`_init_indices`."""
    if init_idx is None:
        init_idx = _init_indices(sample.shape[0], n_clusters, seed)
    centroids = sample[torch.as_tensor(np.array(init_idx), dtype=torch.long, device=sample.device)]
    for _ in range(iters):
        assign = (sample @ centroids.t()).argmax(dim=1)  # first max on ties
        one_hot = torch.nn.functional.one_hot(assign, n_clusters).to(sample.dtype)
        sums = one_hot.t() @ sample
        counts = one_hot.sum(dim=0)[:, None]
        new = torch.where(counts > 0, sums / counts.clamp(min=1), centroids)
        centroids = new / torch.linalg.vector_norm(new, dim=1, keepdim=True).clamp(min=1e-9)
    return centroids


def _top2(chunk: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(rows, 2) best and second-best centroid per row; ties go to the lower
    index first, as ``lax.top_k`` orders them."""
    s = mm_f32(chunk, cent.t())
    first = s.argmax(dim=1)
    second = s.scatter(1, first[:, None], NEG_INF).argmax(dim=1)
    return torch.stack([first, second], dim=1)


def _sample_rows(pieces_fn, n: int, d: int, rows: np.ndarray) -> np.ndarray:
    """Gather sorted global ``rows`` from row-contiguous pieces (one pass)."""
    out = np.empty((len(rows), d), np.float32)
    base = 0
    for piece in pieces_fn():
        piece = np.asarray(piece)
        lo = np.searchsorted(rows, base)
        hi = np.searchsorted(rows, base + piece.shape[0])
        if hi > lo:
            out[lo:hi] = piece[rows[lo:hi] - base]
        base += piece.shape[0]
    if base != n:
        raise RuntimeError(f"pieces supplied {base} rows, expected {n}")
    return out


def _assign_top2(pieces_fn, n: int, centroids: np.ndarray, device, step: int = 262_144):
    """Streaming assignment pass: (assign, second) int32 arrays of size n.

    Every chunk is scored on ``device``: in bf16 on CUDA (as the reference
    does on a TPU), in f32 on the CPU. The (step, 2) result of chunk i is
    read back only after chunk i+1 has been dispatched, so the host read
    and copy of chunk i+1 overlap the device's work on chunk i."""
    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    assign = np.empty(n, np.int32)
    second = np.empty(n, np.int32)
    cent = torch.from_numpy(np.asarray(centroids, np.float32)).to(device, dtype)

    def harvest(pending):
        off, length, idx2 = pending
        host = idx2.cpu().numpy()
        assign[off : off + length] = host[:, 0]
        second[off : off + length] = host[:, 1]

    pending = None  # (offset, length, in-flight device result)
    base = 0
    with torch.inference_mode():
        for piece in pieces_fn():
            for s in range(0, piece.shape[0], step):
                chunk = host_tensor(piece[s : s + step]).to(device).to(dtype)
                idx2 = _top2(chunk, cent)
                if pending is not None:
                    harvest(pending)
                pending = (base + s, chunk.shape[0], idx2)
            base += piece.shape[0]
        if pending is not None:
            harvest(pending)
    return assign, second


def _place_rows(
    assign: np.ndarray, second: np.ndarray, n_clusters: int, rows_per_cluster: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pure-integer slot assignment: (cluster, slot) per row, plus leftovers.

    Round 1 packs every row into its best cluster (stable order); overflow
    spills to the second-best; rows that overflow BOTH are returned for the
    capacity-aware round (they need vectors, which the fill pass collects).
    Returns (cluster (n,) i32 with -1 = leftover, slot (n,) i32,
    fill (n_clusters,) i64, leftover row indices sorted ascending).
    """
    n = len(assign)
    cluster = np.full(n, -1, np.int32)
    slot = np.zeros(n, np.int32)
    fill = np.zeros(n_clusters, np.int64)

    def pack(rows: np.ndarray, cluster_of: np.ndarray) -> np.ndarray:
        order = np.argsort(cluster_of, kind="stable")
        rows_s, clus_s = rows[order], cluster_of[order]
        boundary = np.r_[True, clus_s[1:] != clus_s[:-1]]
        run_start = np.maximum.accumulate(
            np.where(boundary, np.arange(len(clus_s)), 0)
        )
        rank = np.arange(len(clus_s)) - run_start
        slots = fill[clus_s] + rank
        ok = slots < rows_per_cluster
        cluster[rows_s[ok]] = clus_s[ok]
        slot[rows_s[ok]] = slots[ok]
        np.add.at(fill, clus_s[ok], 1)
        return rows_s[~ok]

    overflow_rows = pack(np.arange(n, dtype=np.int64), assign)
    leftover = np.array([], np.int64)
    if len(overflow_rows):  # one spill round into second-best clusters
        leftover = np.sort(pack(overflow_rows, second[overflow_rows]))
    return cluster, slot, fill, leftover


@dataclass
class IVFIndex:
    """Cluster-major packed corpus + centroids on one device."""

    centroids: torch.Tensor  # (n_clusters, D) f32
    blocks: torch.Tensor  # (n_clusters, rows_per_cluster, D) bf16 / f32 / int8
    row_map: np.ndarray  # (n_clusters, rows_per_cluster) -> original row or -1
    n_actual: int
    scales: torch.Tensor | None = None  # (n_clusters, rpc) f32 when blocks are int8
    build_seconds: dict = field(default_factory=dict)  # host clock per build step
    valid: torch.Tensor = field(init=False, repr=False)  # (n_clusters, rpc) int32 on blocks' device

    def __post_init__(self):
        self.valid = torch.from_numpy((self.row_map >= 0).astype(np.int32)).to(self.blocks.device)

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def rows_per_cluster(self) -> int:
        return self.blocks.shape[1]

    @property
    def padding_waste(self) -> float:
        """Fraction of block slots that are padding (device memory overhead
        of the static cluster-major layout)."""
        total = self.row_map.size
        return 1.0 - (self.row_map >= 0).sum() / total if total else 0.0


def _as_tensor(arr) -> torch.Tensor:
    """A host array (numpy, including ml_dtypes bfloat16) as a torch tensor
    with the same bits."""
    arr = np.array(arr)  # a writable copy: the source may be read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def ivf_index_from_arrays(
    centroids, blocks, row_map, n_actual: int, scales=None, device="cuda"
) -> IVFIndex:
    """An :class:`IVFIndex` on ``device`` from host arrays, e.g. the arrays
    of an index the reference package built (``np.asarray`` of its fields):
    the same bits, so both packages can search one index."""
    device = torch.device(device)
    return IVFIndex(
        centroids=_as_tensor(centroids).to(device, torch.float32),
        blocks=_as_tensor(blocks).to(device),
        row_map=np.asarray(row_map, np.int64),
        n_actual=int(n_actual),
        scales=None if scales is None else _as_tensor(scales).to(device, torch.float32),
    )


def build_ivf(
    emb,
    n_clusters: int = 128,
    sample_size: int = 100_000,
    kmeans_iters: int = 10,
    seed: int = 0,
    overflow: float = 1.5,
    block_dtype: torch.dtype = torch.bfloat16,
    max_overflow: float = 4.0,
    n_rows: int | None = None,
    dim: int | None = None,
    device="cuda",
    device_blocks: bool = True,
) -> IVFIndex:
    """Fit centroids on a sample, assign all rows, pack cluster-major.

    ``emb`` is either an (N, D) float array or a zero-arg callable returning
    an iterator of row-contiguous f32 pieces (``VectorIndex.
    iter_matrix_pieces`` over mmap shards); pass ``n_rows``/``dim`` with the
    callable. Pieces are read three times (sample, assignment, fill); the
    only O(N) host allocations are the packed blocks in their storage dtype
    (a torch bf16 or int8 tensor, copied to ``device`` once at the end) and
    two int32 assignment vectors.

    ``overflow`` sizes rows_per_cluster to overflow x N/n_clusters, at least
    the 95th-percentile cluster, at most ``max_overflow`` x N/n_clusters,
    rounded up to 128; rows of over-full clusters spill into their
    second-best cluster, then into the best-scoring cluster with room.

    ``device_blocks=False`` leaves the blocks and scales in host memory
    (the k-means and assignment still run on ``device``): the mesh path
    hands them to :func:`shard_ivf`, and no single-device staging copy is
    made.
    """
    device = torch.device(device)
    if callable(emb):
        pieces_fn = emb
        if n_rows is None or dim is None:
            raise ValueError("streaming build_ivf needs n_rows and dim")
        n, d = n_rows, dim
    else:
        arr = np.asarray(emb)
        n, d = arr.shape

        def pieces_fn():
            return iter([arr])

    seconds = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n_sample = min(sample_size, n)
    sample_rows = np.sort(rng.choice(n, n_sample, replace=False))
    sample = _sample_rows(pieces_fn, n, d, sample_rows)
    n_clusters = max(1, min(n_clusters, n_sample))  # k-means needs k <= n
    seconds["sample"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with torch.inference_mode():
        centroids = _kmeans_fit(torch.from_numpy(sample).to(device), seed, n_clusters, kmeans_iters)
        centroids = centroids.cpu().numpy()
    del sample
    seconds["kmeans"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if n_clusters == 1:
        # top-2 selection needs >= 2 columns; with one cluster every row
        # (and its spill target) is cluster 0
        assign = np.zeros(n, np.int32)
        second = np.zeros(n, np.int32)
    else:
        assign, second = _assign_top2(pieces_fn, n, centroids, device)
    seconds["assign"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mean_rows = n / n_clusters
    rows_per_cluster = int(np.ceil(mean_rows * overflow))
    counts = np.bincount(assign, minlength=n_clusters)
    rows_per_cluster = max(rows_per_cluster, int(np.percentile(counts, 95)))
    rows_per_cluster = min(rows_per_cluster, int(np.ceil(mean_rows * max_overflow)))
    rows_per_cluster = -(-rows_per_cluster // 128) * 128

    cluster, slot, fill, leftover = _place_rows(assign, second, n_clusters, rows_per_cluster)
    del assign, second
    seconds["place"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    quantized = block_dtype == torch.int8
    blocks = torch.zeros((n_clusters, rows_per_cluster, d), dtype=block_dtype)
    row_map = np.full((n_clusters, rows_per_cluster), -1, np.int64)
    # Padding rows get scale 1 (harmless: their scores are masked by valid).
    scales_np = np.ones((n_clusters, rows_per_cluster), np.float32) if quantized else None
    leftover_vecs = np.empty((len(leftover), d), np.float32)

    def write_rows(c: np.ndarray, s: np.ndarray, vecs: np.ndarray, gids: np.ndarray):
        """Convert (and for int8 quantize per row) then write into blocks."""
        ci, si = torch.from_numpy(c.astype(np.int64)), torch.from_numpy(s.astype(np.int64))
        if quantized:
            sc = np.abs(vecs).max(axis=1) / 127.0
            sc = np.maximum(sc, 1e-12).astype(np.float32)
            blocks[ci, si] = torch.from_numpy(np.clip(np.rint(vecs / sc[:, None]), -127, 127).astype(np.int8))
            scales_np[c, s] = sc
        else:
            blocks[ci, si] = torch.from_numpy(vecs).to(block_dtype)
        row_map[c, s] = gids

    if len(leftover):
        logger.warning(
            "IVF spilling %d rows capacity-aware (skewed clusters; overflow=%.1f cap=%.1f)",
            len(leftover), overflow, max_overflow,
        )
    base = 0
    for piece in pieces_fn():  # fill pass
        piece = np.asarray(piece, np.float32)
        gids = np.arange(base, base + piece.shape[0], dtype=np.int64)
        c = cluster[base : base + piece.shape[0]]
        placed = c >= 0
        write_rows(c[placed], slot[base : base + piece.shape[0]][placed], piece[placed], gids[placed])
        lo = np.searchsorted(leftover, base)
        hi = np.searchsorted(leftover, base + piece.shape[0])
        if hi > lo:
            leftover_vecs[lo:hi] = piece[leftover[lo:hi] - base]
        base += piece.shape[0]
    del cluster, slot

    if len(leftover):
        scores = leftover_vecs @ centroids.T  # (L, k)
        prefs = np.argsort(-scores, axis=1)
        free = rows_per_cluster - fill
        lc = np.full(len(leftover), -1, np.int64)
        ls = np.full(len(leftover), -1, np.int64)
        for i, row_prefs in enumerate(prefs):
            for c in row_prefs:
                if free[c] > 0:
                    lc[i] = c
                    ls[i] = rows_per_cluster - free[c]
                    free[c] -= 1
                    break
        if (lc < 0).any():
            # Only reachable with a caller-forced overflow below the >= 1.0
            # capacity invariant; writing the -1s would scatter rows into
            # the last cluster (a corrupt index), so refuse loudly.
            raise ValueError(
                f"IVF capacity exhausted: {int((lc < 0).sum())} of {len(leftover)} spilled rows "
                f"found no cluster with free space (n_clusters * rows_per_cluster < n_rows; "
                f"raise overflow/max_overflow)"
            )
        write_rows(lc, ls, leftover_vecs, leftover)
    seconds["fill"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    blocks_at = device if device_blocks else torch.device("cpu")
    index = IVFIndex(
        centroids=torch.from_numpy(centroids).to(device),
        blocks=blocks.to(blocks_at),
        row_map=row_map,
        n_actual=n,
        scales=torch.from_numpy(scales_np).to(blocks_at) if quantized else None,
    )
    seconds["to_device"] = time.perf_counter() - t0
    index.build_seconds = seconds
    logger.info(
        "IVF built: %d clusters x %d rows/cluster, %.1f%% padding waste (%.2f GiB blocks at %s); seconds %s",
        n_clusters, rows_per_cluster, 100 * index.padding_waste,
        blocks.numel() * blocks.element_size() / 2**30, block_dtype,
        {k: round(v, 3) for k, v in seconds.items()},
    )
    return index


# -- search --------------------------------------------------------------------


def _ivf_search_device(
    q: torch.Tensor,
    centroids: torch.Tensor,
    blocks: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    nprobe: int,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device part: probe the top-``nprobe`` clusters per query, exact top-k
    inside. Returns (scores (B, k_eff), padded positions (B, k_eff) encoded
    as cluster * rows_per_cluster + slot)."""
    b = q.shape[0]
    rpc = blocks.shape[1]
    _, probe = _sorted_topk(mm_f32(q, centroids.t()), nprobe)  # (B, nprobe)
    probe = probe.to(torch.int32)
    flat = probe_scores(probe, q, blocks, valid, scales).reshape(b, nprobe * rpc)
    slots = torch.arange(rpc, device=q.device)
    pos = (probe[:, :, None].long() * rpc + slots).reshape(b, nprobe * rpc)
    top_v, top_i = _sorted_topk(flat, min(k, nprobe * rpc))
    return top_v, torch.gather(pos, 1, top_i)


def ivf_search(index: IVFIndex, q, k: int, nprobe: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Host wrapper: (scores (B, k) f32, original row ids (B, k) i64, -1
    pads). The query scores in bf16 against int8 blocks, never in int8."""
    q_dtype = torch.bfloat16 if index.scales is not None else index.blocks.dtype
    device = index.blocks.device
    q = (q if torch.is_tensor(q) else host_tensor(q)).to(device, q_dtype)
    with torch.inference_mode():
        vals, pos = _ivf_search_device(
            q, index.centroids.to(q_dtype), index.blocks, index.valid, k,
            min(nprobe, index.n_clusters), scales=index.scales,
        )
    vals, pos = vals.cpu().numpy(), pos.cpu().numpy()
    rows = index.row_map.reshape(-1)[pos]
    rows = np.where(vals > NEG_INF, rows, -1)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=NEG_INF)
        rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
    return vals, rows


# -- the cluster-sharded tier --------------------------------------------------


@dataclass
class ShardedIVF:
    """IVF with cluster blocks sharded over the mesh's ``shards`` axis.

    Shard ``s`` holds clusters ``[s * cpl, (s + 1) * cpl)``, once on each
    distinct device of its mesh column (``parts[s][device]`` = (centroids
    (cpl, D), blocks (cpl, rpc, D), valid (cpl, rpc) int32, scales (cpl,
    rpc) f32 or None)). Every shard probes the top-``nprobe`` of its OWN
    clusters: a globally top-``nprobe`` cluster is within the top of its
    shard, so the union covers a superset of the single-device probe set.
    Centroids are kept in the blocks' dtype (bf16 over int8 blocks)."""

    mesh: object
    cpl: int  # clusters per shard
    parts: dict[int, dict[torch.device, tuple]]
    row_map: np.ndarray  # (nc_pad, rpc) host: padded position -> original row, -1
    n_actual: int
    n_clusters_actual: int
    quantized: bool

    @property
    def rows_per_cluster(self) -> int:
        return self.row_map.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(next(iter(self.parts.values())).values()))[1].dtype

    def nbytes(self) -> int:
        """Device bytes of every buffer this process holds."""
        return sum(t.numel() * t.element_size() for by_dev in self.parts.values() for arrays in by_dev.values()
                   for t in arrays if t is not None)


def shard_parts(mesh, cpl: int, centroids, blocks, valid, scales, shards, first: int = 0) -> dict:
    """``parts`` of a :class:`ShardedIVF`: for each shard of ``shards``, its
    ``cpl`` clusters of the given arrays (which start at shard ``first``)
    copied once to each distinct device of its mesh column."""
    from tensortruth_tpu_torch.parallel.sharded_topk import place

    parts = {}
    for s in shards:
        cut = slice((s - first) * cpl, (s - first + 1) * cpl)
        arrays = [a[cut] for a in (centroids, blocks, valid)] + [None if scales is None else scales[cut]]
        placed = [None if a is None else place(a.contiguous(), mesh.shard_devices(s)) for a in arrays]
        parts[s] = {d: tuple(None if p is None else p[d] for p in placed) for d in mesh.shard_devices(s)}
    return parts


def shard_ivf(index: IVFIndex, mesh) -> ShardedIVF:
    """Place an :class:`IVFIndex` cluster-sharded on the mesh (clusters
    padded to a multiple of the shard count: zero blocks, no valid slot,
    scale 1, row -1). The index's blocks may be in host memory
    (``build_ivf(device_blocks=False)``)."""
    from tensortruth_tpu_torch.parallel.mesh import SHARD_AXIS

    p = mesh.shape[SHARD_AXIS]
    nc, rpc = index.n_clusters, index.rows_per_cluster
    nc_pad = -(-nc // p) * p
    quantized = index.scales is not None
    blocks = index.blocks.cpu()
    centroids = index.centroids.cpu().to(torch.bfloat16 if quantized else blocks.dtype)
    valid = torch.from_numpy((index.row_map >= 0).astype(np.int32))
    scales = index.scales.cpu() if quantized else None
    row_map = index.row_map
    if nc_pad != nc:
        extra = nc_pad - nc
        blocks = torch.cat([blocks, blocks.new_zeros((extra, rpc, blocks.shape[2]))])
        centroids = torch.cat([centroids, centroids.new_zeros((extra, centroids.shape[1]))])
        valid = torch.cat([valid, valid.new_zeros((extra, rpc))])
        row_map = np.concatenate([row_map, np.full((extra, rpc), -1, row_map.dtype)])
        if quantized:
            scales = torch.cat([scales, scales.new_ones((extra, rpc))])
    cpl = nc_pad // p
    return ShardedIVF(
        mesh=mesh, cpl=cpl, parts=shard_parts(mesh, cpl, centroids, blocks, valid, scales, range(p)),
        row_map=row_map, n_actual=index.n_actual, n_clusters_actual=nc, quantized=quantized,
    )


def _shard_ivf_topk(q, arrays, cluster0: int, *, k: int, nprobe: int, n_clusters_actual: int, plain: bool):
    """One shard: its centroid scores (padded clusters -inf), the top
    ``nprobe`` of its own clusters, their probe scores (B4, or its plain
    version) and the local top-k at global positions."""
    centroids, blocks, valid, scales = arrays
    b, cpl, rpc = q.shape[0], blocks.shape[0], blocks.shape[1]
    cscores = mm_f32(q, centroids.t())
    cid = cluster0 + torch.arange(cpl, device=q.device)
    _, probe = _sorted_topk(cscores.masked_fill(cid >= n_clusters_actual, NEG_INF), nprobe)
    probe = probe.to(torch.int32)
    scores = (probe_scores_plain if plain else probe_scores)(probe, q, blocks, valid, scales)
    slots = torch.arange(rpc, device=q.device)
    pos = ((cluster0 + probe.long())[:, :, None] * rpc + slots).reshape(b, nprobe * rpc)
    top_v, top_i = _sorted_topk(scores.reshape(b, nprobe * rpc), min(k, nprobe * rpc))
    return top_v, torch.gather(pos, 1, top_i)


def shard_ivf_candidates(sidx: ShardedIVF, q: torch.Tensor, k: int, nprobe: int, plain: bool = False) -> list:
    """Launch every held shard's local search (on the first device of its
    column); returns ``[(scores, positions)]`` per held shard, in order, on
    the shards' devices."""
    from tensortruth_tpu_torch.parallel.mesh import on

    out = []
    np_l = min(nprobe, sidx.cpl)
    for s in sorted(sidx.parts):
        dev = sidx.mesh.shard_devices(s)[0]
        with on(dev):
            out.append(_shard_ivf_topk(q.to(dev, non_blocking=True), sidx.parts[s][dev], s * sidx.cpl, k=k,
                                       nprobe=np_l, n_clusters_actual=sidx.n_clusters_actual, plain=plain))
    return out


def positions_to_rows(sidx: ShardedIVF, vals: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Padded positions -> original rows, -1 where the slot is empty."""
    rows = np.where(pos >= 0, sidx.row_map.reshape(-1)[np.maximum(pos, 0)], -1)
    return np.where(vals > NEG_INF, rows, -1)


def ivf_search_sharded(
    sidx: ShardedIVF, q, k: int, nprobe: int = 8, plain: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Host wrapper for the sharded tier: same returns as :func:`ivf_search`
    (the query scores in bf16 against int8 blocks). ``plain`` probes each
    shard through :func:`probe_scores_plain` (what B4 is held against)."""
    lead = sidx.mesh.lead
    q = (q if torch.is_tensor(q) else host_tensor(q)).to(lead, torch.bfloat16 if sidx.quantized else sidx.dtype)
    with torch.inference_mode():
        cands = shard_ivf_candidates(sidx, q, k, nprobe, plain=plain)
        vals, pos = merge_candidates(torch.cat([v.to(lead) for v, _ in cands], dim=1),
                                     torch.cat([p.to(lead) for _, p in cands], dim=1), k)
    vals, pos = vals.cpu().numpy(), pos.cpu().numpy()
    return vals, positions_to_rows(sidx, vals, pos)
