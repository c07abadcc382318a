"""Sharded dense retrieval: per-shard partial top-k, candidates merged on the
mesh's lead device.

Port of ``tensortruth_tpu/parallel/sharded_topk.py``. The (N, D) corpus is
row-sharded over the mesh's ``shards`` axis: shard ``s`` holds rows
``[s * per_shard, (s + 1) * per_shard)`` once on each distinct device of its
column (:class:`ShardedCorpus`), zero-padded past row N. A search runs, per
shard and on that shard's device, the port's B1 (``fused_topk``), B2
(``fused_topk_int8``) or ``exact_topk`` over the shard's first ``n_valid``
rows, rebases the local ids by ``s * per_shard`` and masks invalid slots to
-inf / -1; the (B, k) candidates then go to the lead device and merge in
shard-major order through one stable top-k, so ties resolve as
``lax.top_k`` does over the reference's all-gathered candidates. Every
shard's launch is issued before any candidate is copied back, but the host
issues one shard's whole share (B1 / B2, then about 20 small launches of
selection, masking and rebasing) before the next shard's B1: shards on
several cards overlap only where a card's kernels outlast the host's issue
of the next shard. Traced on four H100s (``scripts/measure_mesh.py``), each
card's B1 started after the previous card's had ended; on one card the
shards run one after another in any case.

Where the reference's ``shard_map`` runs every (data, shard) slot, a
replicated query batch here runs once per shard (on the first device of its
column): every data row would compute the same thing. With ``q_sharded``
each data row's slice of the batch runs on its own row of the grid.

A shard that holds no valid row (a trailing all-padding shard, e.g. 5 rows
over 4 shards of 2048) launches nothing and contributes -inf / -1 directly:
the kernels need at least one valid row, and the reference's masked result
for such a shard is exactly that.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tensortruth_tpu_torch.ops.ivf import host_tensor
from tensortruth_tpu_torch.ops.topk import (
    NEG_INF,
    exact_topk,
    fused_topk,
    fused_topk_int8,
    fused_topk_int8_plain,
    fused_topk_plain,
    merge_candidates,
    quantize_corpus,
)
from tensortruth_tpu_torch.parallel.mesh import DATA_AXIS, SHARD_AXIS, Mesh, on

Parts = dict[int, dict[torch.device, torch.Tensor]]  # shard -> device -> its rows there


def _per_shard_rows(n: int, p: int, tile_n: int | None) -> int:
    per_shard = -(-n // p)
    if tile_n:
        per_shard = -(-per_shard // tile_n) * tile_n
    return per_shard


@dataclass
class ShardedCorpus:
    """An (n_pad, D) corpus row-sharded over ``mesh``: ``parts[s][device]``
    holds rows ``[s * per_shard, (s + 1) * per_shard)`` on ``device``, for
    the shards this process holds. ``scales``: the int8 tier's f32 row
    scales, laid out alike (zero on padding rows)."""

    mesh: Mesh
    per_shard: int
    parts: Parts
    scales: Parts | None = None

    @property
    def n_pad(self) -> int:
        return self.per_shard * self.mesh.shape[SHARD_AXIS]

    def _any(self) -> torch.Tensor:
        return next(iter(next(iter(self.parts.values())).values()))

    @property
    def dtype(self) -> torch.dtype:
        return self._any().dtype

    @property
    def shape(self) -> tuple[int, int]:
        return self.n_pad, self._any().shape[1]

    def nbytes(self) -> int:
        """Device bytes of every buffer this process holds (rows + scales)."""
        tensors = [t for parts in (self.parts, self.scales or {}) for by_dev in parts.values() for t in by_dev.values()]
        return sum(t.numel() * t.element_size() for t in tensors)

    def to_host(self) -> torch.Tensor:
        """The (n_pad, D) rows in shard order, on the CPU (every shard must be
        held here)."""
        return torch.cat([next(iter(self.parts[s].values())).cpu() for s in range(self.mesh.shape[SHARD_AXIS])])


def _rows_of(piece) -> torch.Tensor:
    """A host piece as a CPU tensor: torch tensors keep their dtype, arrays
    are read as float32 without a copy."""
    return piece.cpu() if torch.is_tensor(piece) else host_tensor(piece)


def _iter_shard_buffers(pieces, n: int, dim: int, per_shard: int, p: int, dtype: torch.dtype):
    """Re-chunk row-contiguous pieces into exactly-``per_shard`` buffers.

    Yields (shard index, (per_shard, dim) CPU buffer in ``dtype``), each
    freshly allocated and zero-padded past row ``n``. Peak host memory is one
    shard buffer plus one incoming piece, never the full matrix."""
    buf = torch.zeros((per_shard, dim), dtype=dtype)
    si = fill = total = 0
    for piece in pieces:
        piece = _rows_of(piece)
        off = 0
        while off < piece.shape[0]:
            take = min(per_shard - fill, piece.shape[0] - off)
            buf[fill : fill + take] = piece[off : off + take]
            fill += take
            off += take
            total += take
            if fill == per_shard:
                yield si, buf
                si += 1
                fill = 0
                buf = torch.zeros((per_shard, dim), dtype=dtype)
    if total != n:
        raise RuntimeError(f"matrix pieces supplied {total} rows, expected {n}")
    while si < p:  # trailing all-padding shards
        yield si, buf
        si += 1
        fill = 0
        buf = torch.zeros((per_shard, dim), dtype=dtype)


def place(buf: torch.Tensor, devices: list[torch.device]) -> dict[torch.device, torch.Tensor]:
    """One copy of ``buf`` per distinct device (none where it already is)."""
    return {d: buf.to(d) for d in devices}


def shard_corpus_streaming(
    pieces, n: int, dim: int, mesh: Mesh, dtype: torch.dtype = torch.bfloat16, tile_n: int | None = None
) -> tuple[ShardedCorpus, int]:
    """Place an (n, dim) corpus row-sharded on the mesh FROM PIECES.

    ``pieces`` iterates row-contiguous f32 arrays (``VectorIndex.
    iter_matrix_pieces`` over mmap shards): each shard's buffer is filled in
    ``dtype``, copied to its devices and dropped. Pass ``tile_n`` (B1's
    tile) so each shard is tile-aligned here, once. Returns (corpus, n)."""
    p = mesh.shape[SHARD_AXIS]
    per_shard = _per_shard_rows(n, p, tile_n)
    parts = {si: place(buf, mesh.shard_devices(si))
             for si, buf in _iter_shard_buffers(pieces, n, dim, per_shard, p, dtype)}
    return ShardedCorpus(mesh, per_shard, parts), n


def shard_corpus(emb, mesh: Mesh, tile_n: int | None = None) -> tuple[ShardedCorpus, int]:
    """Array-in-hand wrapper over :func:`shard_corpus_streaming` (one
    piece); keeps the input's dtype (a numpy array is read as float32)."""
    rows = _rows_of(emb)
    return shard_corpus_streaming(iter([rows]), rows.shape[0], rows.shape[1], mesh, dtype=rows.dtype, tile_n=tile_n)


def shard_corpus_int8_streaming(pieces, n: int, dim: int, mesh: Mesh, tile_n: int | None = None):
    """int8-quantize row-contiguous f32 pieces straight onto the mesh.

    Per-row scales (``quantize_corpus``) are row-local, so each shard
    quantizes and places on its own; padding rows get scale 0. Returns
    (corpus with ``scales``, n)."""
    p = mesh.shape[SHARD_AXIS]
    per_shard = _per_shard_rows(n, p, tile_n)
    parts, scales = {}, {}
    for si, buf in _iter_shard_buffers(pieces, n, dim, per_shard, p, torch.float32):
        q, s = quantize_corpus(buf.numpy())
        s[int(np.clip(n - si * per_shard, 0, per_shard)):] = 0.0
        devices = mesh.shard_devices(si)
        parts[si], scales[si] = place(torch.from_numpy(q), devices), place(torch.from_numpy(s), devices)
    return ShardedCorpus(mesh, per_shard, parts, scales), n


def shard_corpus_int8(emb, mesh: Mesh, tile_n: int | None = None):
    """Array-in-hand wrapper over :func:`shard_corpus_int8_streaming`."""
    rows = _rows_of(emb).to(torch.float32)
    return shard_corpus_int8_streaming(iter([rows]), rows.shape[0], rows.shape[1], mesh, tile_n=tile_n)


def _shard_topk(q, rows, scales, k: int, n_valid: int, *, use_fused: bool, m: int, tile_n: int, plain: bool):
    """One shard's local top-k over its first ``n_valid`` rows: B2, the
    dequantised exact product, B1 or the exact product (``plain``: the
    kernels' plain versions)."""
    if scales is not None and use_fused:
        fn = fused_topk_int8_plain if plain else fused_topk_int8
        return fn(q, rows, scales, k, m=m, tile_n=tile_n, n_valid=n_valid)
    if scales is not None:
        return exact_topk(q, rows.to(q.dtype) * scales[:, None].to(q.dtype), k, n_valid=n_valid)
    if use_fused:
        fn = fused_topk_plain if plain else fused_topk
        return fn(q, rows, k, m=m, tile_n=tile_n, n_valid=n_valid)
    return exact_topk(q, rows, k, n_valid=n_valid)


def shard_candidates(
    q: torch.Tensor,
    emb: ShardedCorpus,
    *,
    k: int,
    n_actual: int,
    data_row: int | None = None,
    use_fused: bool = False,
    m: int = 1,
    tile_n: int = 2048,
    plain: bool = False,
) -> list:
    """Launch the local top-``min(k, per_shard)`` of every shard this
    process holds, on the device of ``data_row`` in its column (any of
    them when None). Returns, per held shard in order, (scores, global ids)
    on the shard's device, masked to -inf / -1 past ``n_actual`` (None for
    a shard with no valid row)."""
    local_n = emb.per_shard
    k_local = min(k, local_n)
    out = []
    for s in sorted(emb.parts):
        dev = emb.mesh.grid[data_row][s] if data_row is not None else emb.mesh.shard_devices(s)[0]
        n_valid = int(np.clip(n_actual - s * local_n, 0, local_n))
        if n_valid == 0:
            out.append(None)
            continue
        scales = emb.scales[s][dev] if emb.scales is not None else None
        with on(dev):
            vals, idx = _shard_topk(q.to(dev, non_blocking=True), emb.parts[s][dev], scales, k_local, n_valid,
                                    use_fused=use_fused, m=m, tile_n=tile_n, plain=plain)
            valid = (idx >= 0) & (idx < n_valid)
            out.append((vals.masked_fill(~valid, NEG_INF), (idx + s * local_n).masked_fill(~valid, -1)))
    return out


def gather_candidates(cands: list, b: int, k_local: int, device: torch.device):
    """Candidates of :func:`shard_candidates` on ``device``, shard-major:
    ((B, S * k_local) scores, ids); a shard with no valid row is -inf / -1."""
    vals, ids = [], []
    for c in cands:
        v, i = c if c is not None else (torch.full((b, k_local), NEG_INF), torch.full((b, k_local), -1))
        vals.append(v.to(device, non_blocking=True))
        ids.append(i.to(device, torch.int32, non_blocking=True))
    return torch.cat(vals, dim=1), torch.cat(ids, dim=1)


def sharded_topk(
    q,
    emb: ShardedCorpus,
    *,
    k: int,
    n_actual: int,
    use_fused: bool = False,
    m: int = 1,
    tile_n: int = 2048,
    q_sharded: bool = False,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a row-sharded corpus.

    q: (B, D) normalised queries, replicated, or split over the ``data``
    axis when ``q_sharded`` (each data row's slice merges its own
    candidates). The int8 tier's scales travel in ``emb``: the fused path
    rescales inside B2, the exact path dequantises the shard. ``plain`` runs
    each shard through the kernels' plain versions (what the kernels are
    held against). Returns (scores (B, k) f32, global ids (B, k) int32) on
    the mesh's lead device; padded rows never appear (-inf / -1)."""
    mesh = emb.mesh
    lead = mesh.lead
    if len(emb.parts) != mesh.shape[SHARD_AXIS]:
        raise ValueError("sharded_topk needs every shard in this process (GlobalMeshSearch searches a global mesh)")
    q = q if torch.is_tensor(q) else host_tensor(q)
    n_data = mesh.shape[DATA_AXIS] if q_sharded else 1
    if q.shape[0] % n_data:
        raise ValueError(f"q_sharded needs a batch divisible by {n_data} data rows, got {q.shape[0]}")
    per = q.shape[0] // n_data
    kw = dict(k=k, n_actual=n_actual, use_fused=use_fused, m=m, tile_n=tile_n, plain=plain)
    launched = [shard_candidates(q[r * per : (r + 1) * per], emb, data_row=r if q_sharded else None, **kw)
                for r in range(n_data)]  # every launch before any copy back
    k_local = min(k, emb.per_shard)
    merged = [merge_candidates(*gather_candidates(cands, per, k_local, lead), k) for cands in launched]
    return torch.cat([v for v, _ in merged]), torch.cat([i for _, i in merged])


def sharded_topk_search(q, emb: ShardedCorpus, k: int, n_actual: int, **kw) -> tuple[np.ndarray, np.ndarray]:
    """Host-friendly wrapper: numpy in, numpy out."""
    with torch.inference_mode():
        vals, idx = sharded_topk(q, emb, k=k, n_actual=n_actual, **kw)
    return vals.cpu().numpy(), idx.cpu().numpy()
