"""VectorIndex: the persisted per-module index artifact.

Replaces the reference's Chroma collection + LlamaIndex docstore +
``index_metadata.json`` triple (reference indexing/builder.py:424-453,
indexing/metadata.py:103-147). One directory per module:

    embeddings.npy        (N, D) float32 L2-normalized leaf embeddings
    rows.json             row→node_id map + tombstone mask + doc→rows map
    hierarchy.jsonl       full node hierarchy (index/nodes.py)
    index_metadata.json   build contract {embedding_model, created_at,
                          index_version, chunk_sizes, chunk_overlap,
                          chunking_strategy}

Mutation model (SURVEY.md §7 hard part (e)): the matrix is append-only;
``remove_document`` tombstones rows instantly, ``add_nodes`` appends rows.
The *device* copy is compacted lazily — `matrix()` returns only alive rows
plus a row-map back to node ids, so searches never see dead rows and the
device array is rebuilt only after a mutation (cf. the reference's in-place
Chroma delete, document_index.py:478-581).
"""

from __future__ import annotations

import datetime
import json
import os
from pathlib import Path

import numpy as np

from tensortruth_tpu_torch.index.nodes import HierarchyStore, Node

INDEX_VERSION = "1.0"
METADATA_FILE = "index_metadata.json"
EMB_FILE = "embeddings.npy"
EMB_MANIFEST = "embeddings.manifest.json"
ROWS_FILE = "rows.json"
HIER_FILE = "hierarchy.jsonl"

# Matrices above this row count persist as per-shard arrays + a manifest
# (orbax-style; SURVEY.md §5.4 TPU checkpointing equivalent) so 1M+-row
# indexes stream shard-by-shard at load and individual shards can be placed
# directly onto mesh devices.
SHARD_ROWS = 250_000


def _stage_matrix(path: Path, emb: np.ndarray):
    """Stage the matrix files; return ``(commit, abort)``.

    ``np.save`` over an existing file truncates before writing, so a
    concurrent load (CLI rebuild racing a running server on one module
    dir) would mmap a torn file — everything is staged under PID-tagged
    tmp names here, and ``commit()`` swaps them in with ``os.replace``
    under the module's swap guard (the same — reentrant — flock the packed
    hierarchy uses), which the load path also holds while opening the file
    set. ``abort()`` unlinks the staged tmps if the caller fails before
    committing. Stale tmp files from crashed savers are swept when their
    PID is gone.
    """
    import os

    from tensortruth_tpu_torch.index.packed import _swap_guard

    sweep = ("embeddings*.tmp-*", f"{ROWS_FILE}.tmp-*", f"{METADATA_FILE}.tmp-*")
    for pattern in sweep:
        for stale in path.glob(pattern):
            try:
                pid = int(stale.name.rsplit(".tmp-", 1)[1])
                os.kill(pid, 0)
            except (ValueError, IndexError, PermissionError):
                continue  # unparseable or alive-but-other-user: leave it
            except ProcessLookupError:
                stale.unlink(missing_ok=True)

    def _write_npy(tmp: Path, arr: np.ndarray) -> None:
        with open(tmp, "wb") as f:  # explicit handle: tmp has no .npy suffix
            np.save(f, arr)

    renames, shards = [], []

    def abort() -> None:
        for tmp, _dst in renames:
            tmp.unlink(missing_ok=True)

    def stage(fname: str, write) -> None:
        tmp = path / f"{fname}.tmp-{os.getpid()}"
        renames.append((tmp, path / fname))  # pre-append: abort() unlinks
        # a half-written tmp too when write() itself fails
        write(tmp)

    try:
        if emb.shape[0] <= SHARD_ROWS:
            stage(EMB_FILE, lambda t: _write_npy(t, emb))
            keep: set[str] = set()
            single = True
        else:
            single = False
            n_shards = -(-emb.shape[0] // SHARD_ROWS)
            for i in range(n_shards):
                rows = emb[i * SHARD_ROWS : (i + 1) * SHARD_ROWS]
                fname = f"embeddings.shard{i:04d}.npy"
                stage(fname, lambda t, r=rows: _write_npy(t, r))
                shards.append({"file": fname, "rows": int(rows.shape[0])})
            stage(
                EMB_MANIFEST,
                lambda t: t.write_text(
                    json.dumps(
                        {
                            "n_rows": int(emb.shape[0]),
                            "dim": int(emb.shape[1]),
                            "dtype": str(emb.dtype),
                            "shard_rows": SHARD_ROWS,
                            "shards": shards,
                        }
                    )
                ),
            )
            keep = {s["file"] for s in shards}
    except BaseException:
        abort()
        raise

    def commit() -> None:
        with _swap_guard(path):
            # shards land before the manifest that lists them; extinct
            # shard files and the other form's files go last
            for tmp, dst in renames:
                os.replace(tmp, dst)
            for old in path.glob("embeddings.shard*.npy"):
                if old.name not in keep:
                    old.unlink()
            if single:
                manifest = path / EMB_MANIFEST
                if manifest.exists():
                    manifest.unlink()
            else:
                legacy = path / EMB_FILE
                if legacy.exists():
                    legacy.unlink()

    return commit, abort


class CorruptIndexError(RuntimeError):
    """A persisted index's manifest/shards are inconsistent or unreadable.

    Raised instead of whatever numpy/json would throw so callers (engine
    load, startup checks) can distinguish 'rebuild this index' from a bug."""


class ShardedMatrix:
    """Lazy view over per-shard .npy memmaps — the capacity-tier load path.

    A 10M×1024 f32 matrix is 40 GB; materializing it on the host just to
    quantize it down to a 10 GB int8 device corpus wastes more RAM than many
    hosts have. This object exposes ``shape``/``dtype``/``iter_shards()`` so
    the engine can stream shard→quantize→place without ever holding the
    full f32 corpus; ``__array__`` materializes as a documented fallback for
    paths that genuinely need one array (mesh bf16 sharding, IVF build)."""

    def __init__(self, mmaps: list[np.ndarray], n_rows: int, dim: int, dtype):
        self._mmaps = mmaps
        self.shape = (n_rows, dim)
        self.dtype = np.dtype(dtype)
        self.ndim = 2

    def iter_shards(self):
        return iter(self._mmaps)

    def __array__(self, dtype=None, copy=None):
        out = np.empty(self.shape, dtype=dtype or self.dtype)
        row = 0
        for m in self._mmaps:
            out[row : row + m.shape[0]] = m
            row += m.shape[0]
        return out

    def astype(self, dtype):
        return self.__array__(dtype=np.dtype(dtype))

    def take_rows(self, rows: np.ndarray) -> np.ndarray:
        """Materialize only the selected (sorted) rows, shard by shard —
        tombstone compaction must not build the full f32 matrix first (a
        10M-row index is 40 GB; the full-materialize + fancy-copy path
        doubles that transiently)."""
        rows = np.asarray(rows)
        order = None
        if len(rows) > 1 and not (rows[1:] >= rows[:-1]).all():
            order = np.argsort(rows, kind="stable")
            rows = rows[order]
        out = np.empty((len(rows), self.shape[1]), dtype=self.dtype)
        base = filled = 0
        for m in self._mmaps:
            sel = rows[(rows >= base) & (rows < base + m.shape[0])] - base
            if len(sel):
                out[filled : filled + len(sel)] = m[sel]
                filled += len(sel)
            base += m.shape[0]
        if filled != len(rows):
            # Unmatched rows would otherwise leave np.empty garbage in the
            # output; __getitem__ is a generic surface, so keep the old
            # np.asarray(self)[key] contract of raising on bad indices.
            raise IndexError(
                f"{len(rows) - filled} row indices out of range for "
                f"{self.shape[0]} rows"
            )
        if order is not None:
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            out = out[inv]
        return out

    def __getitem__(self, key):  # fancy row selection (tombstone compaction)
        if isinstance(key, np.ndarray) and key.ndim == 1:
            if key.dtype == bool:
                key = np.flatnonzero(key)
            return self.take_rows(key)
        return np.asarray(self)[key]


def _load_matrix(path: Path, mmap: bool = False) -> np.ndarray:
    """``mmap=True`` (read-only indexes) avoids materializing the matrix:
    single-file → np.memmap; sharded → ShardedMatrix over per-shard mmaps."""
    manifest = path / EMB_MANIFEST
    if not manifest.exists():
        try:
            return np.load(path / EMB_FILE, mmap_mode="r" if mmap else None)
        except Exception as e:
            raise CorruptIndexError(
                f"unreadable embeddings at {path / EMB_FILE}: {e}"
            ) from e
    try:
        m = json.loads(manifest.read_text())
        shards = m["shards"]
        n_rows, dim, dtype = m["n_rows"], m["dim"], np.dtype(m["dtype"])
    except (json.JSONDecodeError, KeyError, TypeError) as e:
        raise CorruptIndexError(f"unreadable shard manifest at {manifest}: {e}") from e
    mmaps, row = [], 0
    for shard in shards:
        f = path / shard["file"]
        if not f.exists():
            raise CorruptIndexError(f"missing shard {f} (manifest lists it)")
        try:
            arr = np.load(f, mmap_mode="r")
        except Exception as e:  # truncated/zero-byte/garbage .npy
            raise CorruptIndexError(f"unreadable shard {f}: {e}") from e
        if arr.ndim != 2 or arr.shape[0] != shard["rows"] or arr.shape[1] != dim:
            raise CorruptIndexError(
                f"shard {f} shape {arr.shape} != manifest ({shard['rows']}, {dim})"
            )
        if row + arr.shape[0] > n_rows:
            raise CorruptIndexError(
                f"shards over-supply rows (> {n_rows} manifest total) at {f}"
            )
        mmaps.append(arr)
        row += arr.shape[0]
    if row != n_rows:
        raise CorruptIndexError(
            f"shards supply {row} rows, manifest claims {n_rows} at {path}"
        )
    lazy = ShardedMatrix(mmaps, n_rows, dim, dtype)
    return lazy if mmap else np.asarray(lazy)


def sanitize_model_id(model_id: str) -> str:
    """'BAAI/bge-m3' → 'bge-m3' (reference indexing/metadata.py:22-52)."""
    return model_id.split("/")[-1].replace(" ", "-")


class VectorIndex:
    """One module's leaf-embedding matrix + node hierarchy + metadata."""

    def __init__(
        self,
        emb: np.ndarray,
        row_ids: list[str],
        store: HierarchyStore,
        metadata: dict | None = None,
        alive: np.ndarray | None = None,
    ):
        if emb.ndim != 2 or len(row_ids) != emb.shape[0]:
            # Mixed-generation artifacts (a crash between the matrix commit
            # and the rows.json rename leaves the new matrix beside the old
            # row map): a 'rebuild me' signal, not an internal bug — and
            # unlike an assert, it still fires under ``python -O``.
            raise CorruptIndexError(
                f"matrix shape {emb.shape} disagrees with row map "
                f"({len(row_ids)} row ids)"
            )
        self._emb = np.ascontiguousarray(emb, dtype=np.float32)
        self._row_ids = list(row_ids)
        self._row_of = {nid: i for i, nid in enumerate(row_ids)}
        self.store = store
        self.metadata = metadata or {}
        self._alive = (
            alive.astype(bool) if alive is not None else np.ones(len(row_ids), bool)
        )
        self._compact_cache: tuple[np.ndarray, np.ndarray] | None = None

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        nodes: list[Node],
        embed_fn,
        embedding_model: str = "",
        chunk_sizes: list[int] | None = None,
        chunk_overlap: int = 64,
        chunking_strategy: str = "hierarchical",
        batch_size: int = 64,
        gelu_flavor: str = "",
    ) -> "VectorIndex":
        """ALL nodes go to the hierarchy store, ONLY leaves are embedded
        (reference builder.py:420-442). ``gelu_flavor`` records the encoder's
        GELU variant ("tanh"/"exact") so old-index/new-query math mismatches
        are detectable at engine load (models/embedder.py gelu_flavor)."""
        store = HierarchyStore()
        store.add_all(nodes)
        leaf_ids = store.finalize_leaves()
        leaves = [store.get(nid).text for nid in leaf_ids]
        emb = embed_fn(leaves) if leaves else np.zeros((0, 1), np.float32)
        emb = np.asarray(emb, dtype=np.float32)
        meta = {
            "embedding_model": embedding_model,
            "created_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            "index_version": INDEX_VERSION,
            "chunk_sizes": chunk_sizes or [2048, 512, 256],
            "chunk_overlap": chunk_overlap,
            "chunking_strategy": chunking_strategy,
        }
        if gelu_flavor:
            meta["gelu"] = gelu_flavor
        return cls(emb, leaf_ids, store, meta)

    # -- introspection ---------------------------------------------------------

    @property
    def dim(self) -> int:
        return self._emb.shape[1]

    @property
    def n_rows(self) -> int:
        """Physical rows including tombstones."""
        return self._emb.shape[0]

    @property
    def n_alive(self) -> int:
        return int(self._alive.sum())

    def __len__(self) -> int:
        return self.n_alive

    def node_of_row(self, row: int) -> Node:
        return self.store.get(self._row_ids[row])

    # -- search-surface ------------------------------------------------------

    def matrix(self) -> tuple[np.ndarray, np.ndarray]:
        """(alive_emb (A, D) f32, row_map (A,) i32 physical-row indices).

        Compacted view for device placement; cached until the next mutation.
        Fully-alive indexes (every built module before any delete) return
        the backing array itself — no fancy-index copy, which matters at
        the 10M-row tier where a copy is 40 GB.
        """
        if self._compact_cache is None:
            if self._alive.all():
                rows = np.arange(self.n_rows, dtype=np.int32)
                self._compact_cache = (self._emb, rows)
            else:
                rows = np.flatnonzero(self._alive).astype(np.int32)
                self._compact_cache = (self._emb[rows], rows)
        return self._compact_cache

    def iter_matrix_pieces(self):
        """Yield the alive matrix as row-contiguous pieces without
        materializing the whole — the engine's streaming-quantize path.
        Mutated (tombstoned) indexes fall back to one compacted piece."""
        if not self._alive.all():
            yield self.matrix()[0]
            return
        if isinstance(self._emb, ShardedMatrix):
            yield from self._emb.iter_shards()
        else:
            step = SHARD_ROWS
            for i in range(0, self.n_rows, step):
                yield self._emb[i : i + step]

    def rows_to_nodes(self, rows: np.ndarray) -> list[Node]:
        return [self.store.get(self._row_ids[r]) for r in rows]

    # -- mutation (reference document_index.py:478-581 contract) -------------

    def add_nodes(self, nodes: list[Node], embed_fn) -> int:
        """Incremental add: hierarchy gets ALL nodes, matrix gets the leaves."""
        self.store.add_all(nodes)
        leaves = [n for n in nodes if n.is_leaf]
        if not leaves:
            return 0
        new_emb = np.asarray(embed_fn([n.text for n in leaves]), dtype=np.float32)
        self._emb = np.concatenate([self._emb, new_emb], axis=0)
        for n in leaves:
            self._row_of[n.node_id] = len(self._row_ids)
            self._row_ids.append(n.node_id)
        self._alive = np.concatenate([self._alive, np.ones(len(leaves), bool)])
        self._compact_cache = None
        return len(leaves)

    def remove_document(self, doc_id: str) -> int:
        """Tombstone every leaf row of a document; prune the hierarchy."""
        removed_leaves = self.store.remove_doc(doc_id)
        for nid in removed_leaves:
            row = self._row_of.get(nid)
            if row is not None:
                self._alive[row] = False
        if removed_leaves:
            self._compact_cache = None
        return len(removed_leaves)

    def compact(self) -> None:
        """Physically drop tombstoned rows (periodic maintenance)."""
        if self._alive.all():
            return
        rows = np.flatnonzero(self._alive)
        self._emb = np.ascontiguousarray(self._emb[rows])
        self._row_ids = [self._row_ids[r] for r in rows]
        self._row_of = {nid: i for i, nid in enumerate(self._row_ids)}
        self._alive = np.ones(len(self._row_ids), bool)
        self._compact_cache = None

    # -- persistence -----------------------------------------------------------

    def save(self, path: str | Path, packed: bool | None = None) -> None:
        """Persist. Large hierarchies (≥ PACK_THRESHOLD nodes, or
        ``packed=True``) switch to the mmap-backed packed format
        (index/packed.py) — O(1) loads and flat host RSS at the 10M-chunk
        tier; small/mutable scopes stay on JSONL.

        Two-phase vs readers: ALL artifacts (matrix, pack or JSONL
        hierarchy, metadata) are staged first without any lock, then
        renamed into place in ONE swap-guarded window — a concurrent
        ``load`` (which opens under the same guard) sees either the whole
        old generation or the whole new one, never a mix."""
        from tensortruth_tpu_torch.index.packed import (
            PACK_THRESHOLD,
            _swap_guard,
            stage_pack,
        )

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        commit_matrix, abort_matrix = _stage_matrix(path, self._emb)
        use_packed = packed if packed is not None else len(self.store) >= PACK_THRESHOLD
        mtmp = path / (METADATA_FILE + f".tmp-{os.getpid()}")
        mtmp.write_text(json.dumps(self.metadata, indent=2))
        if use_packed:
            try:
                commit_pack, cleanup_pack, abort_pack = stage_pack(
                    path, self.store, self._row_ids, self._alive
                )
            except BaseException:
                abort_matrix()
                mtmp.unlink(missing_ok=True)
                raise
            try:
                with _swap_guard(path):
                    commit_matrix()
                    commit_pack()
                    for stale in (path / ROWS_FILE, path / HIER_FILE):
                        if stale.exists():
                            stale.unlink()
                    mtmp.replace(path / METADATA_FILE)
            except BaseException:
                abort_pack()
                abort_matrix()  # unlinks whatever tmps weren't renamed yet
                mtmp.unlink(missing_ok=True)
                raise
            cleanup_pack()  # multi-GB packed.old rmtree: outside the guard
        else:
            rtmp = path / (ROWS_FILE + f".tmp-{os.getpid()}")
            try:
                rtmp.write_text(
                    json.dumps(
                        {
                            "row_ids": self._row_ids,
                            "alive": self._alive.astype(int).tolist(),
                        }
                    )
                )
                with _swap_guard(path):
                    commit_matrix()
                    rtmp.replace(path / ROWS_FILE)
                    self.store.save(path / HIER_FILE)  # atomic internally
                    mtmp.replace(path / METADATA_FILE)
            except BaseException:
                abort_matrix()
                rtmp.unlink(missing_ok=True)
                mtmp.unlink(missing_ok=True)
                raise

    @classmethod
    def load(cls, path: str | Path) -> "VectorIndex":
        from tensortruth_tpu_torch.index.packed import _swap_guard, is_packed

        path = Path(path)
        # The whole open sequence runs under the module's swap guard: a
        # save()'s rename phase (or a pack swap) landing mid-sequence would
        # otherwise hand this reader a mix of old/new files. Once the
        # mmaps/file contents are in hand, later replaces are harmless
        # (POSIX keeps renamed-over data alive for open handles). Readers
        # take the guard SHARED so concurrent loads of one module don't
        # serialize on each other cross-process — only against a writer's
        # exclusive rename window (is_packed's crash-heal upgrades to
        # exclusive in place if it needs to rename).
        with _swap_guard(path, shared=True):
            if is_packed(path):
                return PackedVectorIndex.load_packed(path)
            if not (path / ROWS_FILE).exists():
                # Embeddings + metadata present but no hierarchy at all (e.g.
                # a crash wiped the pack and there never was a JSONL store):
                # callers must see 'rebuild this index', not FileNotFoundError.
                raise CorruptIndexError(
                    f"index at {path} has embeddings but no hierarchy "
                    f"({ROWS_FILE} missing and no valid packed/ dir)"
                )
            emb = _load_matrix(path)
            rows = json.loads((path / ROWS_FILE).read_text())
            store = HierarchyStore.load(path / HIER_FILE)
            meta = json.loads((path / METADATA_FILE).read_text())
        return cls(
            emb,
            rows["row_ids"],
            store,
            meta,
            alive=np.asarray(rows["alive"], dtype=bool),
        )

    @staticmethod
    def is_valid(path: str | Path) -> bool:
        """Validity = artifacts exist (reference metadata.py:202-219)."""
        path = Path(path)
        has_matrix = (path / EMB_FILE).exists() or (path / EMB_MANIFEST).exists()
        return has_matrix and (path / METADATA_FILE).exists()


class PackedVectorIndex(VectorIndex):
    """Read-only VectorIndex over the packed hierarchy format.

    Row bookkeeping is an int64 array into the packed node table instead of
    10M-string lists + dicts, and the store hydrates nodes straight off the
    mmap — host RSS stays flat at the capacity tier. Mutation raises:
    built modules are immutable (a rebuild replaces the directory, exactly
    the reference's module contract, indexing/builder.py:333-335)."""

    def __init__(self, emb, row_nodes, alive, store, metadata):
        # Keep mmap/ShardedMatrix backings lazy — read-only indexes never
        # mutate the matrix, and a contiguous-f32 copy here would defeat
        # the whole streaming load path.
        self._emb = (
            emb
            if isinstance(emb, ShardedMatrix) or isinstance(emb, np.memmap)
            else np.ascontiguousarray(emb, dtype=np.float32)
        )
        self._row_nodes = np.asarray(row_nodes, np.int64)
        self.store = store
        self.metadata = metadata or {}
        self._alive = np.asarray(alive, bool)
        self._compact_cache: tuple[np.ndarray, np.ndarray] | None = None
        if not (self._emb.shape[0] == len(self._row_nodes) == len(self._alive)):
            # Mixed-generation artifacts (matrix from one save, pack from
            # another): a 'rebuild me' signal, not an internal bug.
            raise CorruptIndexError(
                f"matrix rows ({self._emb.shape[0]}) disagree with packed "
                f"row map ({len(self._row_nodes)}) / alive ({len(self._alive)})"
            )

    @classmethod
    def load_packed(cls, path: str | Path) -> "PackedVectorIndex":
        from tensortruth_tpu_torch.index.packed import PackedHierarchyStore

        path = Path(path)
        store = PackedHierarchyStore(path)
        meta = json.loads((path / METADATA_FILE).read_text())
        return cls(
            _load_matrix(path, mmap=True),
            store.row_nodes(),
            store.alive(),
            store,
            meta,
        )

    def node_of_row(self, row: int) -> Node:
        i = int(self._row_nodes[row])
        if i < 0:  # tombstoned row whose node was pruned at pack time
            raise KeyError(f"row {row} is tombstoned")
        return self.store.by_index(i)

    def rows_to_nodes(self, rows: np.ndarray) -> list[Node]:
        return [self.node_of_row(int(r)) for r in rows]

    def _read_only(self, op: str):
        from tensortruth_tpu_torch.index.packed import ReadOnlyHierarchyError

        raise ReadOnlyHierarchyError(op)

    def add_nodes(self, nodes, embed_fn) -> int:
        self._read_only("add_nodes")

    def remove_document(self, doc_id: str) -> int:
        self._read_only("remove_document")

    def compact(self) -> None:
        self._read_only("compact")

    def save(self, path: str | Path, packed: bool | None = None) -> None:
        self._read_only("save")


def resolve_module_dir(model_dir: Path, module: str) -> Path | None:
    """First VALID index dir for ``module`` under a model's index root.

    Accepts both bare module names and ``{doc_type}_{module}`` dir names;
    filters by VectorIndex.is_valid so stray/leftover directories never
    mask the real index (shared by engine.py and the orchestrator's module
    descriptions)."""
    candidates = [model_dir / module] + sorted(model_dir.glob(f"*_{module}"))
    return next((c for c in candidates if VectorIndex.is_valid(c)), None)
