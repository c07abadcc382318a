"""Packed, mmap-backed hierarchy store for large module indexes.

The JSONL ``HierarchyStore`` (index/nodes.py) materializes every node as a
Python dataclass at load — right for ≤100k-node modules and mutable scope
indexes, but a 10M-leaf module (the BASELINE config-5 tier this framework
serves from ONE chip, scripts/bench_10m_int8.py) would need 20+ GB of host
RAM and minutes of JSON parsing before the first query. The reference never
hits this wall only because Chroma+docstore cap out far earlier; a
TPU-native engine whose device side scans 10M rows in 23 ms needs a host
side that can hydrate those rows without loading the corpus into Python.

Packed layout (one ``packed/`` dir next to the embedding shards; everything
numpy-memmapped, so load is O(1) mmap calls, per-node access is O(1) page
reads, and host RSS stays flat no matter the corpus size):

    manifest.json      {version, n_nodes, n_leaves, n_rows, doc_ids, modules}
    ids.bin/ids.off    concatenated UTF-8 node ids + uint64 offsets (N+1)
    texts.bin/.off     node texts, same pattern
    meta.bin/.off      per-node metadata JSON ("" == {})
    levels.npy         int16 (N,)
    doc.npy/mod.npy    int32 (N,) indexes into the manifest vocabularies
    parent.npy         int64 (N,) node index, -1 for roots
    span.npy           int64 (N, 2) char spans
    child_ptr.npy      uint64 (N+1,) CSR row pointers
    child_idx.npy      int64 (ΣC,) CSR child node indexes
    leaf_rows.npy      int64 (L,) node index in leaf order
    leafrow_of.npy     int64 (N,) leaf row per node, -1 for non-leaves
    id_order.npy       int64 (N,) permutation sorting ids bytewise
    row_nodes.npy      int64 (n_rows,) physical matrix row → node index
    alive.npy          bool  (n_rows,) tombstone mask at pack time

id → index lookups binary-search ``id_order`` against the ids blob
(~23 blob probes at 10M nodes); row → node hydration is one array index +
one text slice. The store is READ-ONLY: built modules are immutable in this
framework exactly like the reference's (a rebuild replaces the directory,
reference indexing/builder.py:333-335); mutable session/project scopes stay
on the JSONL store.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np

from tensortruth_tpu_torch.index.nodes import HierarchyStore, Node

PACKED_DIR = "packed"
PACK_VERSION = 1

# Serializes pack_index's rename-aside swap against is_packed's crash-heal
# (which would otherwise rename the old pack back in mid-swap) AND against
# readers opening the pack's file set (a swap landing mid-open-sequence
# would hand the reader a mix of old/new files). In-process the threading
# lock covers the server's executor-vs-request threads; cross-process
# (CLI rebuild vs running server on one module dir) an advisory flock on
# ``packed.lock`` in the module dir extends the same exclusion.
# VectorIndex.save/load reuse the same guard for the flat-matrix rename
# phase, so the guard is REENTRANT per (thread, path): load → is_packed →
# PackedHierarchyStore nest on one module dir without self-deadlock.
import contextlib
import threading

# One lock PER module dir (keyed by realpath), not one global lock: loads
# and saves of unrelated modules must not serialize in-process (a server
# loading 8 modules at startup would otherwise open them one at a time).
_GUARD_LOCKS: dict[str, threading.RLock] = {}
_GUARD_LOCKS_MU = threading.Lock()
_GUARD_STATE = threading.local()


def _lock_for(key: str) -> threading.RLock:
    with _GUARD_LOCKS_MU:
        lk = _GUARD_LOCKS.get(key)
        if lk is None:
            lk = _GUARD_LOCKS[key] = threading.RLock()
        return lk


@contextlib.contextmanager
def _swap_guard(path: str | Path, shared: bool = False):
    """Guard a module dir's artifact-set against mid-sequence swaps.

    ``shared=True`` (readers) takes ``LOCK_SH`` cross-process so concurrent
    loaders of one module don't serialize on each other — only against a
    writer's ``LOCK_EX`` rename window. Nested same-thread calls reuse the
    outer lock; a nested EXCLUSIVE request under a shared outer (load →
    ``is_packed`` crash-heal, which renames) upgrades the flock in place —
    flock(2) may release in the interim, which is safe here because every
    heal/commit re-checks its preconditions after acquiring.
    """
    import os

    key = os.path.realpath(os.fspath(path))
    states = getattr(_GUARD_STATE, "d", None)
    if states is None:
        states = _GUARD_STATE.d = {}
    st = states.get(key)
    if st is not None:  # nested on the same dir: outer holds lock + flock
        st["depth"] += 1
        if not shared and not st["exclusive"] and st["fd"] is not None:
            try:
                import fcntl

                fcntl.flock(st["fd"], fcntl.LOCK_EX)
            except ImportError:
                pass
            st["exclusive"] = True
        try:
            yield
        finally:
            st["depth"] -= 1
        return
    with _lock_for(key):
        lockfile = Path(path) / (PACKED_DIR + ".lock")
        try:
            fd = os.open(lockfile, os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            fd = None  # unwritable dir (read-only mount): in-process only
        st = states[key] = {"depth": 1, "fd": fd, "exclusive": not shared}
        try:
            if fd is not None:
                try:
                    import fcntl

                    fcntl.flock(fd, fcntl.LOCK_SH if shared else fcntl.LOCK_EX)
                except ImportError:  # non-POSIX: in-process lock only
                    pass
            yield
        finally:
            states.pop(key, None)
            if fd is not None:
                os.close(fd)  # releases the flock

# VectorIndex.save switches to the packed format at this node count —
# big enough that every session/project scope index stays JSONL-mutable,
# small enough that any "module" scale corpus gets O(1) loads.
PACK_THRESHOLD = 200_000


class ReadOnlyHierarchyError(RuntimeError):
    """Mutation attempted on a packed (immutable) module index."""

    def __init__(self, op: str):
        super().__init__(
            f"{op}: packed module indexes are immutable — rebuild the module "
            "to change it (tensor-truth-tpu-build), or keep documents in a "
            "session/project scope for incremental add/remove"
        )


def _write_blob(path: Path, stem: str, strings: list[str]) -> None:
    blobs = [s.encode("utf-8") for s in strings]
    off = np.zeros(len(blobs) + 1, dtype=np.uint64)
    np.cumsum([len(b) for b in blobs], out=off[1:])
    (path / f"{stem}.bin").write_bytes(b"".join(blobs))
    np.save(path / f"{stem}.off.npy", off)


class _Blob:
    """Read side of _write_blob: a flat bytes mmap + offsets."""

    def __init__(self, path: Path, stem: str):
        self._data = np.memmap(path / f"{stem}.bin", dtype=np.uint8, mode="r") \
            if (path / f"{stem}.bin").stat().st_size else np.zeros(0, np.uint8)
        self._off = np.load(path / f"{stem}.off.npy", mmap_mode="r")

    def __len__(self) -> int:
        return len(self._off) - 1

    def raw(self, i: int) -> bytes:
        a, b = int(self._off[i]), int(self._off[i + 1])
        return bytes(self._data[a:b])

    def get(self, i: int) -> str:
        return self.raw(i).decode("utf-8")


def stage_pack(path: str | Path, store: HierarchyStore, row_ids, alive):
    """Stage the packed artifacts; return ``(commit, cleanup, abort)``.

    Crash-atomic also when a ``packed/`` dir already exists: everything is
    written into a per-call ``packed.tmp-<pid>-*/`` staging dir (concurrent
    packers never clobber each other); ``commit()`` renames the old pack
    aside to ``packed.old/`` (atomic) and the new pack in (atomic) under
    the swap guard — reentrant, so a caller already holding the guard can
    batch it with other renames; ``cleanup()`` deletes ``packed.old``
    (call it OUTSIDE any guard — possibly multi-GB); ``abort()`` drops the
    staging dir if the caller fails before committing. Every crash window
    leaves either the old pack intact, the old pack recoverable from
    ``packed.old`` (``is_packed`` renames it back), or the new pack
    complete — never a valid-looking manifest over torn blobs."""
    import os
    import shutil
    import tempfile

    final = Path(path) / PACKED_DIR
    old = Path(path) / (PACKED_DIR + ".old")
    # Each packer stages into its OWN tmp dir (concurrent packers on one
    # module dir — CLI rebuild racing a server reindex — must not clobber
    # each other's half-written staging trees). Names carry the writer's
    # PID so leftovers from crashed processes are swept here; a live
    # process's staging dir is never touched.
    tmp_prefix = PACKED_DIR + ".tmp"
    for stale in Path(path).glob(tmp_prefix + "-*"):
        try:
            pid = int(stale.name[len(tmp_prefix) + 1 :].split("-", 1)[0])
            os.kill(pid, 0)
        except (ValueError, IndexError, PermissionError):
            continue  # unparseable or alive-but-other-user: leave it
        except ProcessLookupError:
            shutil.rmtree(stale, ignore_errors=True)
    legacy = Path(path) / tmp_prefix  # pre-unique-name crash leftover
    if legacy.exists():
        shutil.rmtree(legacy, ignore_errors=True)
    out = Path(
        tempfile.mkdtemp(prefix=f"{tmp_prefix}-{os.getpid()}-", dir=path)
    )
    # mkdtemp creates 0700 dirs; after os.replace this becomes the live
    # packed/ dir, which must stay readable by other users (a CLI rebuild
    # run as a different account than the serving process). Re-apply the
    # umask-respecting mode an ordinary mkdir would have used.
    umask = os.umask(0)
    os.umask(umask)
    os.chmod(out, 0o777 & ~umask)
    try:
        _write_pack(out, store, row_ids, alive)
    except BaseException:
        shutil.rmtree(out, ignore_errors=True)
        raise

    def commit() -> None:
        try:
            _swap_pack_in(path, out, final, old)
        except BaseException:
            shutil.rmtree(out, ignore_errors=True)
            raise

    def cleanup() -> None:
        # packed/ now exists, so no heal can touch packed.old — the
        # (possibly multi-GB) cleanup needs no lock and must not block
        # readers: call AFTER releasing any outer guard.
        if old.exists():
            shutil.rmtree(old, ignore_errors=True)

    def abort() -> None:
        shutil.rmtree(out, ignore_errors=True)

    return commit, cleanup, abort


def pack_index(
    path: str | Path,
    store: HierarchyStore,
    row_ids: list[str],
    alive: np.ndarray,
) -> None:
    """Stage + swap in one call — see ``stage_pack`` for the split form
    (VectorIndex.save commits the pack and the matrix under ONE guard so
    readers never see a mixed-generation file set)."""
    commit, cleanup, _abort = stage_pack(path, store, row_ids, alive)
    commit()
    cleanup()


def _write_pack(
    out: Path, store: HierarchyStore, row_ids: list[str], alive: np.ndarray
) -> None:
    """Write every packed artifact (incl. the manifest, last) into ``out``."""
    nodes = list(store.nodes())
    n = len(nodes)
    idx_of = {nd.node_id: i for i, nd in enumerate(nodes)}

    _write_blob(out, "ids", [nd.node_id for nd in nodes])
    _write_blob(out, "texts", [nd.text for nd in nodes])
    _write_blob(
        out, "meta",
        [json.dumps(nd.metadata, ensure_ascii=False) if nd.metadata else ""
         for nd in nodes],
    )

    doc_vocab = sorted({nd.doc_id for nd in nodes})
    mod_vocab = sorted({nd.module for nd in nodes})
    doc_of = {d: i for i, d in enumerate(doc_vocab)}
    mod_of = {m: i for i, m in enumerate(mod_vocab)}

    np.save(out / "levels.npy", np.array([nd.level for nd in nodes], np.int16))
    np.save(out / "doc.npy", np.array([doc_of[nd.doc_id] for nd in nodes], np.int32))
    np.save(out / "mod.npy", np.array([mod_of[nd.module] for nd in nodes], np.int32))
    np.save(
        out / "parent.npy",
        np.array(
            [idx_of.get(nd.parent_id, -1) if nd.parent_id else -1 for nd in nodes],
            np.int64,
        ),
    )
    np.save(out / "span.npy", np.array([(nd.start, nd.end) for nd in nodes], np.int64))

    child_ptr = np.zeros(n + 1, np.uint64)
    np.cumsum([len(nd.child_ids) for nd in nodes], out=child_ptr[1:])
    child_idx = np.fromiter(
        (idx_of[c] for nd in nodes for c in nd.child_ids),
        np.int64,
        count=int(child_ptr[-1]),
    )
    np.save(out / "child_ptr.npy", child_ptr)
    np.save(out / "child_idx.npy", child_idx)

    leaf_rows = np.array([idx_of[i] for i in store.leaf_ids], np.int64)
    leafrow_of = np.full(n, -1, np.int64)
    leafrow_of[leaf_rows] = np.arange(len(leaf_rows))
    np.save(out / "leaf_rows.npy", leaf_rows)
    np.save(out / "leafrow_of.npy", leafrow_of)

    ids_bytes = [nd.node_id.encode("utf-8") for nd in nodes]
    np.save(
        out / "id_order.npy",
        np.array(sorted(range(n), key=ids_bytes.__getitem__), np.int64),
    )

    # Tombstoned rows may reference nodes already pruned from the hierarchy
    # (VectorIndex.remove_document pops them); -1 marks those rows, exactly
    # mirroring the JSONL path where node_of_row on a dead row KeyErrors.
    np.save(
        out / "row_nodes.npy",
        np.array([idx_of.get(r, -1) for r in row_ids], np.int64),
    )
    np.save(out / "alive.npy", np.asarray(alive, bool))

    manifest = {
        "version": PACK_VERSION,
        "n_nodes": n,
        "n_leaves": len(leaf_rows),
        "n_rows": len(row_ids),
        "doc_ids": doc_vocab,
        "modules": mod_vocab,
    }
    (out / "manifest.json").write_text(json.dumps(manifest))


def _swap_pack_in(path: str | Path, out: Path, final: Path, old: Path) -> None:
    """Atomically swap the staged pack ``out`` into place as ``final``.

    The swap and is_packed's crash-heal (which renames packed.old BACK to
    packed/) race each other: a reader healing between the two renames
    below would make os.replace(out, final) hit a repopulated non-empty
    dir. The lock serializes them in-process (server: reindex executor
    thread vs request threads); the retry covers a heal from ANOTHER
    process between our renames.
    """
    import os
    import shutil

    with _swap_guard(path):
        for attempt in range(3):
            try:
                if final.exists():
                    if old.exists():
                        # Stale leftover, or a racing pack's post-guard
                        # cleanup mid-delete (that cleanup runs OUTSIDE the
                        # guard, see below) — tolerate entries vanishing
                        # under the walk. Only cleared when ``final`` holds
                        # a live pack: if ``old`` is the ONLY pack (crash
                        # leftover) it stays heal-able until the new pack
                        # lands.
                        shutil.rmtree(old, ignore_errors=True)
                    os.replace(final, old)  # atomic: old pack stays whole aside
                os.replace(out, final)  # atomic finish: manifest = valid
                break
            except OSError:
                # ENOTEMPTY from a not-fully-cleared ``old``, or a heal from
                # an exotic filesystem between our renames — re-clear, retry.
                # A retry after final→old already succeeded skips the aside
                # (final is gone) and just re-attempts the finish.
                if attempt == 2:
                    raise
                continue


def is_packed(path: str | Path) -> bool:
    """True iff a valid pack exists; self-heals a crash-mid-swap.

    ``pack_index`` renames the old pack aside before renaming the new one
    in; a crash between the two renames leaves only ``packed.old``. Rename
    it back here (atomic) so the module keeps serving the old pack instead
    of surfacing a missing-hierarchy error."""
    p = Path(path) / PACKED_DIR
    if (p / "manifest.json").exists():
        return True
    old = Path(path) / (PACKED_DIR + ".old")
    if not (old / "manifest.json").exists():
        # Nothing to heal: take no exclusive lock. VectorIndex.load calls
        # this under its shared guard, and two processes loading one
        # unpacked module would each wait to upgrade to exclusive for the
        # other's shared lock (they did, on a filesystem whose flock does
        # not drop the shared lock first). A writer cannot be mid-swap
        # while a reader holds the shared guard.
        return False
    with _swap_guard(path):  # never heal while pack_index is mid-swap
        if (old / "manifest.json").exists() and not p.exists():
            import os

            try:
                os.replace(old, p)
            except OSError:
                pass  # lost a cross-FS race — the re-check below decides
            else:
                return True
    # A swap may have completed while we waited on the guard (or the heal
    # lost a race): the manifest, not the failed branch, is the answer —
    # returning False for a healthy pack would misroute the caller to the
    # deleted JSONL path and surface a spurious CorruptIndexError.
    return (p / "manifest.json").exists()


class PackedHierarchyStore:
    """Read-only, mmap-backed drop-in for HierarchyStore's lookup surface."""

    def __init__(self, path: str | Path):
        p = Path(path) / PACKED_DIR
        self._path = p
        # The open sequence below touches ~15 files; a repack swapping the
        # pack aside mid-sequence would hand this reader a mix of old/new
        # files (or a FileNotFoundError). The guard makes open atomic vs
        # swaps; once the mmaps are open, POSIX keeps the data alive even
        # if the files are later renamed/unlinked by a repack (tested:
        # old-mmap reader survives repack). SHARED: readers only exclude
        # the writer's rename window, not each other.
        with _swap_guard(path, shared=True):
            self._open(p)

    def _open(self, p: Path) -> None:
        self.manifest = json.loads((p / "manifest.json").read_text())
        self._ids = _Blob(p, "ids")
        self._texts = _Blob(p, "texts")
        self._meta = _Blob(p, "meta")
        self._levels = np.load(p / "levels.npy", mmap_mode="r")
        self._doc = np.load(p / "doc.npy", mmap_mode="r")
        self._mod = np.load(p / "mod.npy", mmap_mode="r")
        self._parent = np.load(p / "parent.npy", mmap_mode="r")
        self._span = np.load(p / "span.npy", mmap_mode="r")
        self._child_ptr = np.load(p / "child_ptr.npy", mmap_mode="r")
        self._child_idx = np.load(p / "child_idx.npy", mmap_mode="r")
        self._leaf_rows = np.load(p / "leaf_rows.npy", mmap_mode="r")
        self._leafrow_of = np.load(p / "leafrow_of.npy", mmap_mode="r")
        self._id_order = np.load(p / "id_order.npy", mmap_mode="r")
        self._docs = self.manifest["doc_ids"]
        self._mods = self.manifest["modules"]
        # Serving hits the same ids repeatedly (top-k of popular chunks,
        # automerge parent walks); the bisect costs ~50 µs over 10M nodes,
        # the cache ~0.1 µs. Per-instance so the mmap can be GC'd.
        import functools

        self.index_of = functools.lru_cache(maxsize=131072)(self._index_of)

    # -- id → index --------------------------------------------------------

    def _index_of(self, node_id: str) -> int:
        """Binary search over the bytewise-sorted id permutation; -1 if absent."""
        key = node_id.encode("utf-8")
        lo, hi = 0, len(self._id_order)
        while lo < hi:
            mid = (lo + hi) // 2
            probe = self._ids.raw(int(self._id_order[mid]))
            if probe < key:
                lo = mid + 1
            elif probe > key:
                hi = mid
            else:
                return int(self._id_order[mid])
        return -1

    # -- node materialization ------------------------------------------------

    def by_index(self, i: int) -> Node:
        a, b = int(self._child_ptr[i]), int(self._child_ptr[i + 1])
        pid = int(self._parent[i])
        meta = self._meta.get(i)
        return Node(
            node_id=self._ids.get(i),
            text=self._texts.get(i),
            level=int(self._levels[i]),
            doc_id=self._docs[int(self._doc[i])],
            module=self._mods[int(self._mod[i])],
            parent_id=self._ids.get(pid) if pid >= 0 else None,
            child_ids=[self._ids.get(int(c)) for c in self._child_idx[a:b]],
            start=int(self._span[i][0]),
            end=int(self._span[i][1]),
            metadata=json.loads(meta) if meta else {},
        )

    # -- HierarchyStore lookup surface ---------------------------------------

    def __len__(self) -> int:
        return self.manifest["n_nodes"]

    def __contains__(self, node_id: str) -> bool:
        return self.index_of(node_id) >= 0

    def _index_or_raise(self, node_id: str) -> int:
        """index_of with JSONL-store KeyError semantics — a -1 miss fed
        straight into numpy indexing would silently wrap to the LAST node
        (Python negative indexing) and return garbage instead of raising."""
        i = self.index_of(node_id)
        if i < 0:
            raise KeyError(node_id)
        return i

    def get(self, node_id: str) -> Node:
        return self.by_index(self._index_or_raise(node_id))

    def parent(self, node_id: str) -> Node | None:
        pid = int(self._parent[self._index_or_raise(node_id)])
        return self.by_index(pid) if pid >= 0 else None

    # Fast paths for the automerge walk (retrieval/automerge.py): id + count
    # only, no text decode / child-id materialization.
    def parent_id_of(self, node_id: str) -> str | None:
        pid = int(self._parent[self._index_or_raise(node_id)])
        return self._ids.get(pid) if pid >= 0 else None

    def n_children_of(self, node_id: str) -> int:
        i = self._index_or_raise(node_id)
        return int(self._child_ptr[i + 1] - self._child_ptr[i])

    def children(self, node_id: str) -> list[Node]:
        i = self._index_or_raise(node_id)
        a, b = int(self._child_ptr[i]), int(self._child_ptr[i + 1])
        return [self.by_index(int(c)) for c in self._child_idx[a:b]]

    @property
    def leaf_ids(self) -> list[str]:
        """Materializes L strings — avoid on the hot path; kept for parity."""
        return [self._ids.get(int(i)) for i in self._leaf_rows]

    def leaf_by_row(self, row: int) -> Node:
        return self.by_index(int(self._leaf_rows[row]))

    def row_of(self, node_id: str) -> int:
        row = int(self._leafrow_of[self._index_or_raise(node_id)])
        if row < 0:
            raise KeyError(node_id)
        return row

    def nodes(self) -> Iterator[Node]:
        return (self.by_index(i) for i in range(len(self)))

    def leaves(self) -> Iterator[Node]:
        return (self.by_index(int(i)) for i in self._leaf_rows)

    # -- row map for PackedVectorIndex ---------------------------------------

    def row_nodes(self) -> np.ndarray:
        return np.load(self._path / "row_nodes.npy", mmap_mode="r")

    def alive(self) -> np.ndarray:
        return np.load(self._path / "alive.npy")

    # -- mutation: immutable by design ---------------------------------------

    def add(self, node: Node) -> None:
        raise ReadOnlyHierarchyError("add")

    def add_all(self, nodes) -> None:
        raise ReadOnlyHierarchyError("add_all")

    def remove_doc(self, doc_id: str) -> list[str]:
        raise ReadOnlyHierarchyError("remove_doc")

    def finalize_leaves(self) -> list[str]:
        raise ReadOnlyHierarchyError("finalize_leaves")
