"""Dense top-k over the stacked corpus: exact, and fused matmul + bucketed top-k
over a bf16 corpus (kernel B1) or an int8 corpus with per-row scales (B2).

Port of ``tensortruth_tpu/ops/topk.py``. ``fused_topk`` keeps the reference's
candidate semantics exactly: per ``tile_n`` row tile, ``tile_n // m``
strided-bucket maxima max-merged into a ``(B, c_out)`` accumulator where tile
``t * n_rot + b`` feeds candidate block ``b``, earlier segment and earlier
tile winning ties, then an exact top-k over the candidates. Expected loss of
a true top-k item is about k^2 / (2 c_out).

``fused_topk_int8`` is the same over ``quantize_corpus`` output: each f32
score is multiplied by its row's f32 scale after the dot, then bucketed.

Dispatch: a CUDA tensor goes to the hand-written kernels
(``csrc/fused_topk.cu``) or raises; only CPU tensors take the plain PyTorch
versions, :func:`fused_candidates_plain` and
:func:`fused_candidates_int8_plain`. Both kernels are one persistent stream
over the corpus, scheduled by :func:`stream_schedule`; B2's wrapper also
hands it the query with each 16 dims reordered (:func:`permute_dims`).

Ties: ``lax.top_k`` puts the lower index first and ``torch.topk`` promises no
order, so every final selection here is a stable descending sort.

The constants (``tile_n=2048``, ``c_out=2048``, ``m=1``, the 4096-row exact
cut-over) are the reference's, tuned on a TPU and not yet re-measured on the
H100.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tensortruth_tpu_torch import _build
from tensortruth_tpu_torch.ops.matmul import mm_f32

NEG_INF = float("-inf")
EXACT_MAX_ROWS = 4096  # topk_search / embed_topk use the exact path up to here


def _sorted_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1, ties broken toward the lower index (lax.top_k order)."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def pad_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Pad (B, k_eff) results to k columns with -inf / -1."""
    short = k - vals.shape[1]
    if short <= 0:
        return vals, idx
    b = vals.shape[0]
    vals = torch.cat([vals, vals.new_full((b, short), NEG_INF)], dim=1)
    idx = torch.cat([idx, idx.new_full((b, short), -1)], dim=1)
    return vals, idx


def merge_candidates(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Global top-k of shard-major (B, S * k_local) candidate scores and
    ids: one stable top-k (lax.top_k's tie order over the reference's
    all-gathered candidates), padded to k with -inf / -1."""
    top_v, pos = _sorted_topk(cand_v, min(k, cand_v.shape[1]))
    return pad_topk(top_v, torch.gather(cand_i, 1, pos), k)


def exact_topk(
    q: torch.Tensor, emb: torch.Tensor, k: int, n_valid: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full (B, N) f32 score matrix, then top-k. Rows >= ``n_valid`` are
    masked to -inf first. Returns (scores (B, k) f32, indices (B, k) int32)."""
    scores = mm_f32(q, emb.t())
    if n_valid is not None:
        col = torch.arange(scores.shape[1], device=scores.device)
        scores = scores.masked_fill(col >= n_valid, NEG_INF)
    vals, idx = _sorted_topk(scores, k)
    return vals, idx.to(torch.int32)


def _geometry(n: int, n_actual: int, tile_n: int, m: int, c_out: int):
    """(c, c_out, n_rot, inner, num_tiles), as the reference derives them."""
    if tile_n % m != 0:
        raise ValueError(f"tile_n {tile_n} must be a multiple of m {m}")
    c = tile_n // m
    if c % 128 != 0:
        raise ValueError(f"tile_n//m must be a multiple of 128, got {tile_n}//{m}={c}")
    c_out = max(c, min(c_out, -(-n_actual // tile_n) * c))  # <= N/m wide
    c_out = -(-c_out // c) * c  # multiple of c
    num_tiles = -(-n // tile_n)
    n_rot = c_out // c
    inner = -(-num_tiles // n_rot)
    return c, c_out, n_rot, inner, num_tiles


def fused_candidates_plain(
    q: torch.Tensor, emb: torch.Tensor, *, tile_n: int, m: int, c_out: int, n_actual: int, n_valid: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B1: the (B, c_out) candidate values
    and global row indices, bit-for-bit the reference's bucketing."""
    return _bucket_candidates(mm_f32(q, emb.t()), tile_n=tile_n, m=m, c_out=c_out, n_actual=n_actual, n_valid=n_valid)


def fused_candidates_int8_plain(
    q: torch.Tensor, emb_q: torch.Tensor, scales: torch.Tensor, *, tile_n: int, m: int, c_out: int,
    n_actual: int, n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B2: the int8 rows converted to the
    query's dtype (exact), the f32 dot, THEN the f32 row scale, as the
    reference orders them; then B1's bucketing."""
    scores = mm_f32(q, emb_q.to(q.dtype).t()) * scales.to(torch.float32)
    return _bucket_candidates(scores, tile_n=tile_n, m=m, c_out=c_out, n_actual=n_actual, n_valid=n_valid)


def _bucket_candidates(
    scores: torch.Tensor, *, tile_n: int, m: int, c_out: int, n_actual: int, n_valid: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) f32 scores -> (B, c_out) candidate values and global rows.
    ``n_actual`` sets the geometry; rows at or past ``n_valid`` (default
    ``n_actual``) are masked.

    Global row of (tile step t, block r, segment i, slot j) is
    ``((t * n_rot + r) * m + i) * c + j``. Each (block, slot) keeps the
    FIRST maximum over the (t, i) sequence in lexicographic order — the
    reference's strict ``>`` over segments, then over tiles — taken here by
    an explicit smallest-position rule, not by ``argmax``'s tie behaviour.
    """
    b, n = scores.shape
    c, c_out, n_rot, inner, _ = _geometry(n, n_actual, tile_n, m, c_out)
    rows = inner * n_rot * tile_n
    scores = torch.nn.functional.pad(scores, (0, rows - n), value=NEG_INF)
    col = torch.arange(rows, device=scores.device)
    scores = scores.masked_fill(col >= (n_actual if n_valid is None else n_valid), NEG_INF)
    # (B, t, r, i, j) -> (B, r, j, t·i): the per-slot merge sequence
    seq = scores.view(b, inner, n_rot, m, c).permute(0, 2, 4, 1, 3).reshape(b, n_rot, c, inner * m)
    best = seq.amax(dim=-1)
    steps = inner * m
    pos = torch.arange(steps, device=seq.device)
    first = torch.where(seq == best.unsqueeze(-1), pos, steps).amin(dim=-1)
    t, i = first // m, first % m
    r = torch.arange(n_rot, device=seq.device).view(1, n_rot, 1)
    j = torch.arange(c, device=seq.device).view(1, 1, c)
    idx = ((t * n_rot + r) * m + i) * c + j
    idx = torch.where(best == NEG_INF, -1, idx)
    return best.reshape(b, c_out), idx.reshape(b, c_out).to(torch.int32)


_QB = 32  # queries per kernel block (csrc/fused_topk.cu kQB)
_SJ = 64  # candidate slots per kernel step (kSJ)
_MAX_D = 2048  # the block's queries are staged in shared memory
# B2's register fragments take the 16 dims of each k-step in this order:
# fragment k-slots {2t, 2t+1} carry dims {4t, 4t+1}, slots {2t+8, 2t+9} dims
# {4t+2, 4t+3} (csrc/hopper.cuh, consume_int8_box).
DIM_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)
_occupancy: dict[tuple[torch.device, int, bool], tuple[int, int]] = {}


def permute_dims(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., D), D a multiple of 16, with each 16 dims in
    :data:`DIM_ORDER`. Applied to the queries of B2 (and of B4 over int8
    blocks, whose kernel permutes them itself) it matches the order in which
    the kernel's fragments take the corpus rows' dims, so every dot product
    keeps its terms."""
    # dim 4t + 2h + e of each 16 goes to 8h + 2t + e: swap t and h
    return x.unflatten(-1, (-1, 4, 2, 2)).transpose(-3, -2).reshape(x.shape)


def _occupancy_of(device: torch.device, d: int, int8: bool) -> tuple[int, int]:
    """(blocks ``device`` holds at once, consumer warpgroups per block) of
    B2's (``int8``) or B1's persistent partial pass at dimension ``d``,
    cached."""
    key = (device, d, int8)
    if key not in _occupancy:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            err = _build.load().tt_fused_topk_occupancy(int(int8), d, out)
        _build.check(err, "fused_topk_int8 occupancy" if int8 else "fused_topk occupancy")
        _occupancy[key] = (out[0], out[1])
    return _occupancy[key]


@functools.lru_cache(maxsize=256)
def stream_schedule(
    b_pad: int, c: int, n_rot: int, inner: int, m: int, resident: int, consumers: int
) -> tuple[int, int]:
    """(persistent blocks per 32-query block, tile ranges) for the partial
    pass of B1 and of B2, one kernel template. Its work items are (range,
    candidate block, 64-slot chunk), item
    ``(range * n_rot + rot) * chunks + chunk`` walked by worker (block x
    consumers + warpgroup) ``item % workers``; a range is tiles
    ``[r * inner // n_ranges, (r + 1) * inner // n_ranges)`` of each
    candidate block. The blocks split the resident ones between the query
    blocks; the ranges are the fewest whose busiest worker walks at most 2%
    more steps than with the best count (every range adds a (b_pad, c_out)
    partial). Cached: the search over range counts would otherwise cost more
    host time than the kernel."""
    blocks = max(1, resident // (b_pad // _QB))
    workers = blocks * consumers
    per_range = n_rot * (c // _SJ)

    def busiest(r: int) -> int:  # items round-robin over the workers, ranges of at most ceil(inner / r) tiles
        return -(-per_range * r // workers) * -(-inner // r) * m

    least = min(busiest(r) for r in range(1, inner + 1))
    return blocks, min(r for r in range(1, inner + 1) if busiest(r) <= least * 1.02)


def _kernel_operands(q, emb, scales, *, tile_n, m, c_out, n_actual, name):
    """Checks shared by B1 and B2; the query padded to whole blocks and the
    corpus to whole tiles. Returns (q, emb, scales, geometry)."""
    if q.dim() != 2 or emb.dim() != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"{name} shapes {tuple(q.shape)} x {tuple(emb.shape)}")
    if not (q.is_contiguous() and emb.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous q and emb")
    b, d = q.shape
    n = emb.shape[0]
    if d % 16 != 0 or d > _MAX_D:
        raise ValueError(f"{name} kernel needs D % 16 == 0 and D <= {_MAX_D}, got {d}")
    tensors = (q, emb) if scales is None else (q, emb, scales)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} kernel needs all inputs on one CUDA device, got {[str(t.device) for t in tensors]}")
    c, c_out, n_rot, inner, num_tiles = _geometry(n, n_actual, tile_n, m, c_out)
    if c % _SJ != 0:
        raise ValueError(f"{name} kernel needs tile_n//m % {_SJ} == 0, got {c}")
    b_pad = -(-b // _QB) * _QB
    if b_pad != b:
        q = torch.nn.functional.pad(q, (0, 0, 0, b_pad - b))
    if num_tiles * tile_n != n:
        # Copies the corpus; the engine pre-pads once at placement instead.
        emb = torch.nn.functional.pad(emb, (0, 0, 0, num_tiles * tile_n - n))
        if scales is not None:
            scales = torch.nn.functional.pad(scales, (0, num_tiles * tile_n - n))
    if emb.data_ptr() % 32 or q.data_ptr() % 32:
        raise ValueError(f"{name} kernel needs 32-byte aligned q and emb")
    return q, emb, scales, (b, b_pad, d, c, c_out, n_rot, inner)


def _candidate_buffers(n_ranges: int, b_pad: int, c_out: int, device):
    part = [torch.empty((n_ranges, b_pad, c_out), dtype=dt, device=device) for dt in (torch.float32, torch.int32)]
    cand = [torch.empty((b_pad, c_out), dtype=dt, device=device) for dt in (torch.float32, torch.int32)]
    return part, cand


def fused_candidates_cuda(
    q: torch.Tensor, emb: torch.Tensor, *, tile_n: int, m: int, c_out: int, n_actual: int, n_valid: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 on the card: same contract as :func:`fused_candidates_plain`.
    Raises on any input the kernel does not take."""
    if q.dtype != torch.bfloat16 or emb.dtype != torch.bfloat16:
        raise TypeError(f"fused_topk kernel takes bfloat16 q and emb, got {q.dtype}, {emb.dtype}")
    q, emb, _, geometry = _kernel_operands(
        q, emb, None, tile_n=tile_n, m=m, c_out=c_out, n_actual=n_actual, name="fused_topk"
    )
    out = _stream_candidates(q, emb, None, geometry, tile_n=tile_n, m=m, limit=_limit(n_actual, n_valid))
    fused_topk.launches += 1
    return out


def _limit(n_actual: int, n_valid: int | None) -> int:
    """The kernels' row mask: ``n_valid`` when given, else ``n_actual``. A
    kernel needs at least one valid row (its tensor map covers the tiles
    below the limit)."""
    limit = n_actual if n_valid is None else n_valid
    if not 0 < limit <= n_actual:
        raise ValueError(f"fused top-k kernels need 0 < n_valid <= n_actual, got {limit} of {n_actual}")
    return limit


def _stream_candidates(q, emb, scales, geometry, *, tile_n, m, limit):
    """Launch the partial pass (B2 when ``scales`` is given, else B1) and
    the merge over the rows below ``limit``; returns the (b, c_out)
    candidates."""
    b, b_pad, d, c, c_out, n_rot, inner = geometry
    int8 = scales is not None
    blocks, n_ranges = stream_schedule(b_pad, c, n_rot, inner, m, *_occupancy_of(q.device, d, int8))
    (part_vals, part_idx), (cand_vals, cand_idx) = _candidate_buffers(n_ranges, b_pad, c_out, q.device)
    if int8:
        q = permute_dims(q)
    err = _build.load().tt_fused_topk_candidates(
        q.data_ptr(), emb.data_ptr(), scales.data_ptr() if int8 else None, part_vals.data_ptr(),
        part_idx.data_ptr(), cand_vals.data_ptr(), cand_idx.data_ptr(), b_pad, d, limit, tile_n, m, n_rot,
        inner, n_ranges, blocks, _build.stream_of(q),
    )
    _build.check(err, "fused_topk_int8" if int8 else "fused_topk")
    return cand_vals[:b], cand_idx[:b]


def fused_candidates_int8_cuda(
    q: torch.Tensor, emb_q: torch.Tensor, scales: torch.Tensor, *, tile_n: int, m: int, c_out: int,
    n_actual: int, n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B2 on the card: same contract as
    :func:`fused_candidates_int8_plain`. Raises on any input the kernel does
    not take (a bf16 query; int8 rows; f32 scales, one per row)."""
    if q.dtype != torch.bfloat16 or emb_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(
            f"fused_topk_int8 kernel takes bfloat16 q, int8 emb and float32 scales, "
            f"got {q.dtype}, {emb_q.dtype}, {scales.dtype}"
        )
    if scales.shape != (emb_q.shape[0],) or not scales.is_contiguous():
        raise ValueError(f"fused_topk_int8 kernel needs contiguous scales of shape ({emb_q.shape[0]},)")
    q, emb_q, scales, geometry = _kernel_operands(
        q, emb_q, scales, tile_n=tile_n, m=m, c_out=c_out, n_actual=n_actual, name="fused_topk_int8"
    )
    out = _stream_candidates(q, emb_q, scales, geometry, tile_n=tile_n, m=m, limit=_limit(n_actual, n_valid))
    fused_topk_int8.launches += 1
    return out


def fused_topk(
    q: torch.Tensor,
    emb: torch.Tensor,
    k: int,
    m: int = 1,
    tile_n: int = 2048,
    c_out: int = 2048,
    n_actual: int | None = None,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused matmul + bucketed top-k. Same returns as :func:`exact_topk`.

    q (B, D), emb (N, D), both L2-normalised. ``n_actual`` is the valid-row
    count (rows past it are padding). On CUDA tensors this launches kernel B1
    (bf16 only); on CPU tensors it runs the plain version. ``n_valid``
    masks the rows at or past it and leaves the candidate geometry to
    ``n_actual``: one shard of a row-sharded corpus, as the reference's
    traced ``n_valid`` does.
    """
    n_actual = emb.shape[0] if n_actual is None else n_actual
    candidates = fused_candidates_cuda if (q.is_cuda or emb.is_cuda) else fused_candidates_plain
    cand = candidates(q, emb, tile_n=tile_n, m=m, c_out=c_out, n_actual=n_actual, n_valid=n_valid)
    return select_topk(*cand, k, n_actual)


fused_topk.launches = 0  # kernel launches (CUDA path only)


def fused_topk_plain(
    q: torch.Tensor,
    emb: torch.Tensor,
    k: int,
    m: int = 1,
    tile_n: int = 2048,
    c_out: int = 2048,
    n_actual: int | None = None,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_topk` through the plain version on any device (what the
    kernel is held against)."""
    n_actual = emb.shape[0] if n_actual is None else n_actual
    cand = fused_candidates_plain(q, emb, tile_n=tile_n, m=m, c_out=c_out, n_actual=n_actual, n_valid=n_valid)
    return select_topk(*cand, k, n_actual)


def select_topk(cand_vals: torch.Tensor, cand_idx: torch.Tensor, k: int, n_actual: int):
    """Exact top-k over the (B, c_out) candidates, padded to k with -inf / -1."""
    k_eff = min(k, n_actual, cand_vals.shape[1])
    vals, pos = _sorted_topk(cand_vals, k_eff)
    return pad_topk(vals, torch.gather(cand_idx, 1, pos), k)


def fused_topk_int8(
    q: torch.Tensor,
    emb_q: torch.Tensor,
    scales: torch.Tensor,
    k: int,
    m: int = 1,
    tile_n: int = 2048,
    c_out: int = 2048,
    n_actual: int | None = None,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_topk` over an int8 corpus + per-row f32 scales (see
    :func:`quantize_corpus`). Same returns as :func:`exact_topk`; the query
    stays bf16. There is no exact cut-over: small corpora take the fused
    path too. On CUDA tensors this launches kernel B2; on CPU tensors it
    runs the plain version. ``n_valid`` as in :func:`fused_topk`."""
    n_actual = emb_q.shape[0] if n_actual is None else n_actual
    on_card = q.is_cuda or emb_q.is_cuda or scales.is_cuda
    candidates = fused_candidates_int8_cuda if on_card else fused_candidates_int8_plain
    cand = candidates(q, emb_q, scales, tile_n=tile_n, m=m, c_out=c_out, n_actual=n_actual, n_valid=n_valid)
    return select_topk(*cand, k, n_actual)


fused_topk_int8.launches = 0  # kernel launches (CUDA path only)


def fused_topk_int8_plain(
    q: torch.Tensor,
    emb_q: torch.Tensor,
    scales: torch.Tensor,
    k: int,
    m: int = 1,
    tile_n: int = 2048,
    c_out: int = 2048,
    n_actual: int | None = None,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_topk_int8` through the plain version on any device (what
    the kernel is held against)."""
    n_actual = emb_q.shape[0] if n_actual is None else n_actual
    cand = fused_candidates_int8_plain(
        q, emb_q, scales, tile_n=tile_n, m=m, c_out=c_out, n_actual=n_actual, n_valid=n_valid
    )
    return select_topk(*cand, k, n_actual)


def topk_search(
    q: torch.Tensor,
    emb: torch.Tensor,
    k: int,
    *,
    exact: bool = False,
    m: int = 1,
    tile_n: int = 2048,
    n_actual: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact path for small corpora or ``exact=True``, fused otherwise."""
    n = emb.shape[0]
    n_actual = n if n_actual is None else n_actual
    if exact or n_actual <= EXACT_MAX_ROWS:
        k_eff = min(k, n_actual)
        vals, idx = exact_topk(q, emb[:n_actual] if n_actual < n else emb, k_eff)
        return pad_topk(vals, idx, k)
    return fused_topk(q, emb, k, m=m, tile_n=tile_n, n_actual=n_actual)


def pad_corpus_for_fused(emb: np.ndarray, tile_n: int = 2048) -> tuple[np.ndarray, int]:
    """Pad an (N, D) host matrix to a tile multiple once before device
    placement; pass the true N as ``n_actual`` to :func:`fused_topk`."""
    n = emb.shape[0]
    n_pad = -(-n // tile_n) * tile_n
    if n_pad == n:
        return emb, n
    pad = np.zeros((n_pad - n, emb.shape[1]), dtype=emb.dtype)
    return np.concatenate([emb, pad], axis=0), n


def check_topk_agrees(name: str, got, want, tol: float) -> tuple[float, int]:
    """Hold one top-k (scores, ids) against another's, e.g. a kernel's
    against its plain version's: scores within ``tol``, and an id may differ
    only where the two scores at that rank are within it. Raises
    RuntimeError otherwise; returns (max |err|, ids that differ)."""
    (vals, idx), (pvals, pidx) = got, want
    diff = (vals - pvals).abs()
    err = diff.max().item()
    bad = int(((idx != pidx) & (diff > tol)).sum())
    if err > tol or bad:
        raise RuntimeError(f"{name}: max |err| {err}, {bad} index mismatches")
    return err, int((idx != pidx).sum())


def quantize_corpus(emb) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: (emb_q (N, D) int8, scales (N,)
    f32), the reference's arithmetic exactly."""
    emb = np.asarray(emb, dtype=np.float32)
    scales = np.abs(emb).max(axis=1) / 127.0
    scales = np.maximum(scales, 1e-12)
    emb_q = np.clip(np.rint(emb / scales[:, None]), -127, 127).astype(np.int8)
    return emb_q, scales.astype(np.float32)


def quantize_corpus_streaming(pieces, n_rows: int, dim: int, tile_n: int = 2048):
    """:func:`quantize_corpus` + :func:`pad_corpus_for_fused` over
    row-contiguous f32 pieces (mmap shards), never holding the f32 corpus.
    Padding rows are 0 with scale 0. Returns (emb_q (N_pad, D) int8,
    scales (N_pad,) f32, n_actual)."""
    n_pad = -(-n_rows // tile_n) * tile_n
    emb_q = np.zeros((n_pad, dim), np.int8)
    scales = np.zeros(n_pad, np.float32)
    row = 0
    for piece in pieces:
        q, s = quantize_corpus(piece)
        emb_q[row : row + q.shape[0]] = q
        scales[row : row + q.shape[0]] = s
        row += q.shape[0]
    if row != n_rows:
        raise ValueError(f"pieces supplied {row} rows, expected {n_rows}")
    return emb_q, scales, n_rows
