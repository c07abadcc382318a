"""Multi-slice IVF: host-routed cluster groups, the tier past one device's
memory.

Port of ``tensortruth_tpu/parallel/multislice.py``. One device (or one mesh)
bounds the corpus it can hold. Beyond that the corpus splits by IVF cluster
ranges across **slice groups**, each holding its clusters on one device, on
its own mesh (``ops/ivf.py::ShardedIVF``) or in its own worker process, and
the coordinator host routes each query batch to the groups that own its
probed clusters (docs/SCALING.md).

Per query batch:

1. **Route (host):** score the queries against the full centroid table, in
   f32 on the host, and take the global top-``nprobe`` clusters per query.
2. **Scatter:** for each group owning at least one probed cluster, send the
   querying rows with ``nprobe_g`` = the most probed clusters it owns for
   any one query. Groups owning none are skipped.
3. **Probe (per group):** each group runs its IVF search (kernel B4) over
   its own clusters, sharded over its mesh when it has one. The group
   re-selects its top-``nprobe_g`` clusters itself, scoring its centroids
   in the blocks' query dtype (bf16), as the reference's groups do; near a
   tie that set can differ from the clusters the host's f32 routing chose.
4. **Gather + merge (host):** per-group (scores, global row ids) merge by
   score into the final top-k in one vectorised pass.

Steps 2 and 4 ride a pluggable transport (``parallel/transport.py``): groups
run in-process by default (``LocalTransport``), or in worker processes over
a socket RPC (``SocketTransport`` / ``SupervisedTransport`` +
``slice_worker.py``); ``attach_transport`` swaps a group to the remote path
and drops the local index, so its data can only flow across the process
boundary.

Failure isolation (a deliberate difference from the reference, ROADMAP C):
the reference goes on without a group on ANY exception from it, so a failed
kernel (reported by a live worker, or raised in-process) would silently cost
recall. Here a group is isolated only when its worker is gone: an
``OSError`` from its transport (connection refused or reset, timeout, EOF
mid-frame), or a supervised worker that cannot be respawned or has spent
its respawn budget (``SliceWorkerGone``). A failed request
(``SliceWorkerError``: an error the worker reported, or a request that
kills its worker again after the respawn) and any exception of an
in-process group propagate.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from tensortruth_tpu_torch.ops.ivf import IVFIndex, ShardedIVF, ivf_search, ivf_search_sharded, shard_ivf
from tensortruth_tpu_torch.parallel.transport import LocalTransport, SliceWorkerGone, save_ivf_part

logger = logging.getLogger(__name__)

# What a gone worker raises; anything else a transport raises propagates.
WORKER_GONE = (OSError, SliceWorkerGone)


def partition_ivf(index: IVFIndex, n_groups: int) -> list[IVFIndex]:
    """Split an IVFIndex into ``n_groups`` contiguous cluster-range parts.

    The cluster-major packed layout makes this a pure slice: each part's
    tensors are views of the index's (no copy, no host round trip), and it
    keeps the ORIGINAL global row ids in row_map, so merged results need no
    id translation. Ranges are balanced by occupied rows (not cluster
    count), so skewed clusters don't concentrate memory on one group.
    """
    if n_groups < 1:
        raise ValueError("n_groups must be >= 1")
    nc = index.n_clusters
    if n_groups > nc:
        raise ValueError(f"n_groups={n_groups} exceeds n_clusters={nc}")
    occupancy = (index.row_map >= 0).sum(axis=1)  # rows per cluster
    target = occupancy.sum() / n_groups
    bounds = [0]
    acc = 0.0
    for c in range(nc):
        acc += float(occupancy[c])
        # close the current range once it reaches its fair share, keeping
        # enough clusters for the remaining groups
        if acc >= target * len(bounds) and nc - (c + 1) >= n_groups - len(bounds):
            bounds.append(c + 1)
            if len(bounds) == n_groups:
                break
    while len(bounds) < n_groups:
        bounds.append(min(nc - (n_groups - len(bounds)), bounds[-1] + 1))
    bounds.append(nc)

    parts = []
    for g in range(n_groups):
        lo, hi = bounds[g], bounds[g + 1]
        parts.append(
            IVFIndex(
                centroids=index.centroids[lo:hi],
                blocks=index.blocks[lo:hi],
                row_map=index.row_map[lo:hi],
                n_actual=index.n_actual,
                scales=index.scales[lo:hi] if index.scales is not None else None,
            )
        )
    logger.info(
        "partitioned IVF %d clusters into %d groups: %s rows each",
        nc, n_groups,
        [int((p.row_map >= 0).sum()) for p in parts],
    )
    return parts


@dataclass
class SliceGroup:
    """One slice group: a contiguous cluster range on one device or mesh.

    ``search(q, k, nprobe)`` is the RPC surface: a worker process serves it
    over a socket; in-process it calls the group's (sharded) IVF search.
    """

    group_id: int
    cluster_lo: int  # global id of this group's first cluster
    index: IVFIndex | ShardedIVF

    @property
    def n_clusters(self) -> int:
        if isinstance(self.index, ShardedIVF):
            return self.index.n_clusters_actual
        return self.index.n_clusters

    def search(self, q: np.ndarray, k: int, nprobe: int, plain: bool = False):
        """The group's (scores, global rows) (B, k). ``plain`` probes through
        B4's plain version, with the same sharding and routing."""
        nprobe = min(nprobe, self.n_clusters)
        if isinstance(self.index, ShardedIVF):
            return ivf_search_sharded(self.index, q, k=k, nprobe=nprobe, plain=plain)
        return ivf_search(self.index, q, k=k, nprobe=nprobe, plain=plain)


class MultiSliceIVF:
    """Host coordinator: full centroid table + routed slice groups."""

    def __init__(self, index: IVFIndex, n_groups: int, meshes=None):
        """``meshes``: optional per-group mesh list; a group with a mesh
        holds its clusters sharded (ShardedIVF), otherwise on the index's
        device (its part is a view of the index)."""
        self.centroids = index.centroids.float().cpu().numpy()  # (nc, D)
        self.n_actual = index.n_actual
        parts = partition_ivf(index, n_groups)
        self.groups: list[SliceGroup] = []
        lo = 0
        for g, part in enumerate(parts):
            mesh = meshes[g] if meshes else None
            idx = shard_ivf(part, mesh) if mesh is not None else part
            self.groups.append(SliceGroup(group_id=g, cluster_lo=lo, index=idx))
            lo += part.n_clusters
        # cluster id -> owning group
        self._owner = np.concatenate(
            [np.full(p.n_clusters, g, np.int32) for g, p in enumerate(parts)]
        )
        # per-group cluster counts, kept for logging after attach_transport
        # drops the local index (groups[g].index becomes None)
        self._group_sizes = [p.n_clusters for p in parts]
        self.last_failed_groups: list[int] = []
        self.last_touched_groups: list[int] = []
        self.transports = [LocalTransport(g) for g in self.groups]

    def attach_transport(self, group_id: int, transport) -> None:
        """Route ``group_id`` through ``transport`` (e.g. a SocketTransport
        to a slice-worker process) and DROP the local index copy, so the
        group's data can only be reached across the transport boundary."""
        self.transports[group_id] = transport
        self.groups[group_id].index = None

    def save_part(self, group_id: int, path) -> None:
        """Persist one group's partition for a worker process."""
        idx = self.groups[group_id].index
        if isinstance(idx, ShardedIVF):
            raise ValueError("save_part operates on unsharded group indexes")
        save_ivf_part(idx, path)

    def close(self) -> None:
        for t in self.transports:
            t.close()

    def route(self, q: np.ndarray, nprobe: int) -> np.ndarray:
        """(B, nprobe) owning group of each f32 query's globally
        top-``nprobe`` clusters (``nprobe`` at most the cluster count),
        scored against the full centroid table on the host."""
        cscores = q @ self.centroids.T  # (B, nc) host routing matmul
        probe = np.argpartition(-cscores, nprobe - 1, axis=1)[:, :nprobe]
        return self._owner[probe]

    def search(
        self, q, k: int, nprobe: int = 8, plain: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """Route -> per-group probe -> merge. Returns (scores, rows) (B, k).
        ``plain`` probes every group through B4's plain version (tests and
        ``chip_smoke.py``'s checks); only in-process groups take it."""
        q = np.asarray(q, np.float32)
        b = q.shape[0]
        probe_groups = self.route(q, min(nprobe, len(self._owner)))  # (B, nprobe)
        kw = {"plain": True} if plain else {}

        out_v = np.full((b, k), -np.inf, np.float32)
        out_r = np.full((b, k), -1, np.int64)
        merged_v: list[np.ndarray] = []
        merged_r: list[np.ndarray] = []
        merged_q: list[np.ndarray] = []
        touched: list[int] = []
        failed: list[tuple[int, Exception]] = []
        for grp in self.groups:
            hits = probe_groups == grp.group_id  # (B, nprobe)
            rows_mask = hits.any(axis=1)
            if not rows_mask.any():
                continue  # group owns no probed cluster for this batch
            touched.append(grp.group_id)
            nprobe_g = int(hits.sum(axis=1).max())
            qsub = q[rows_mask]
            # A gone worker degrades recall for its clusters, loudly, instead
            # of failing the batch; only if EVERY touched group is gone is
            # the batch unanswerable. Anything else raises.
            try:
                vals, rows = self.transports[grp.group_id].search(
                    qsub, k=k, nprobe=nprobe_g, **kw
                )
            except WORKER_GONE as e:
                logger.error(
                    "slice group %d is gone (%s) — batch continues without "
                    "its %d clusters",
                    grp.group_id, e, self._group_sizes[grp.group_id],
                )
                failed.append((grp.group_id, e))
                continue
            merged_v.append(np.asarray(vals, np.float32))
            merged_r.append(np.asarray(rows, np.int64))
            merged_q.append(np.flatnonzero(rows_mask))
        self.last_failed_groups = [g for g, _ in failed]
        self.last_touched_groups = touched
        if failed and not merged_v and touched:
            raise RuntimeError(
                f"all {len(touched)} probed slice groups failed: "
                + "; ".join(f"group {g}: {e}" for g, e in failed)
            )
        logger.debug("multislice batch touched %d/%d groups", len(touched), len(self.groups))

        # Host merge, fully vectorised (no per-query Python): scatter each
        # group's k candidates into a (B, G*k) slab, then ONE segment-wise
        # top-k over the slab. A corpus row lives in exactly one cluster (one
        # group), so the only repeated id is the -1 pad, masked to -inf so it
        # sorts last.
        g_t = len(merged_v)
        if g_t:
            slab_v = np.full((b, g_t * k), -np.inf, np.float32)
            slab_r = np.full((b, g_t * k), -1, np.int64)
            for gi, (vals, rows, qidx) in enumerate(
                zip(merged_v, merged_r, merged_q)
            ):
                slab_v[qidx, gi * k : (gi + 1) * k] = np.where(
                    rows >= 0, vals, -np.inf
                )
                slab_r[qidx, gi * k : (gi + 1) * k] = rows
            if g_t > 1:
                part = np.argpartition(-slab_v, k - 1, axis=1)[:, :k]
            else:
                part = np.broadcast_to(np.arange(k), (b, k))
            pv = np.take_along_axis(slab_v, part, axis=1)
            order = np.argsort(-pv, axis=1, kind="stable")
            sel = np.take_along_axis(part, order, axis=1)
            out_v = np.take_along_axis(slab_v, sel, axis=1)
            out_r = np.take_along_axis(slab_r, sel, axis=1)
            out_r[~np.isfinite(out_v)] = -1  # -inf slots are padding
        return out_v, out_r
