"""The port's multi-slice tier (tensortruth_tpu_torch/parallel/multislice.py)
against the reference's (tensortruth_tpu/parallel/multislice.py), on the CPU.

One index is built by the reference (bf16 or int8 blocks) and carried across
with ``ivf_index_from_arrays``, so both coordinators route over the same
centroid bits and probe the same blocks: the reference's B4 through its CPU
path, the port's through the plain version (its wrapper on CPU tensors).

* ``partition_ivf``: the same cluster ranges, row maps and block bits; the
  port's parts are views of the index's tensors, each with its own
  ``valid``; the same errors.
* Routed search: the same row ids, scores within 1e-5 (test_torch_ivf.py's
  tolerance for B4 plain against the reference), at several group counts,
  k and nprobe, at B=256 (the vectorised merge), through groups sharded over
  8 CPU slots against the reference's 8 virtual devices, and with
  ``plain=True``. Group skipping calls only the owning group; self-retrieval
  through routing as the reference's test holds it.
* Failure isolation: a ``ConnectionError`` (a gone worker) is isolated in
  both packages. An error a live worker reports, a request that kills its
  supervised worker again after the respawn, and any exception of an
  in-process group, raise in the port; the reference goes on without the
  group, and that is pinned beside it (ROADMAP C). The port leaves such a
  group out only once its respawn budget is spent.
"""

import socket
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensortruth_tpu.ops import ivf as ref_ivf
from tensortruth_tpu.parallel import make_mesh as ref_make_mesh
from tensortruth_tpu.parallel import multislice as ref_ms
from tensortruth_tpu.parallel import transport as ref_tr
from tensortruth_tpu_torch.ops import ivf as port_ivf
from tensortruth_tpu_torch.parallel import make_mesh
from tensortruth_tpu_torch.parallel import multislice as port_ms
from tensortruth_tpu_torch.parallel import transport as port_tr

torch.set_num_threads(1)

ATOL = 1e-5


def _corpus(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bits(blocks) -> np.ndarray:
    if torch.is_tensor(blocks):
        return (blocks.view(torch.int16) if blocks.dtype == torch.bfloat16 else blocks).numpy()
    blocks = np.asarray(blocks)
    return blocks.view(np.int16) if blocks.dtype.name == "bfloat16" else blocks


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def pair(request):
    """(corpus, reference index, the port's copy of it on the CPU)."""
    emb = _corpus(np.random.default_rng(7), 4000, 32)
    dtype = jnp.int8 if request.param == "int8" else jnp.bfloat16
    index = ref_ivf.build_ivf(emb, n_clusters=16, sample_size=4000, kmeans_iters=5, block_dtype=dtype)
    scales = None if index.scales is None else np.asarray(index.scales)
    carried = port_ivf.ivf_index_from_arrays(np.asarray(index.centroids), np.asarray(index.blocks), index.row_map,
                                             index.n_actual, scales=scales, device="cpu")
    return emb, index, carried


def _assert_same(got, want):
    (gv, gr), (wv, wr) = got, want
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    np.testing.assert_array_equal(gr, wr)
    finite = np.isfinite(wv)
    np.testing.assert_allclose(gv[finite], wv[finite], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_groups", [1, 3, 4, 16])
def test_partition_matches_reference(pair, n_groups):
    _, index, carried = pair
    want, got = ref_ms.partition_ivf(index, n_groups), port_ms.partition_ivf(carried, n_groups)
    assert [p.n_clusters for p in got] == [p.n_clusters for p in want]
    base = carried.blocks.untyped_storage().data_ptr()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.row_map, w.row_map)
        np.testing.assert_array_equal(_bits(g.blocks), _bits(w.blocks))
        np.testing.assert_array_equal(g.centroids.numpy(), np.asarray(w.centroids))
        assert (g.scales is None) == (w.scales is None)
        if g.scales is not None:
            np.testing.assert_array_equal(g.scales.numpy(), np.asarray(w.scales))
            assert g.scales.untyped_storage().data_ptr() == carried.scales.untyped_storage().data_ptr()
        assert g.blocks.untyped_storage().data_ptr() == base  # a view, no copy
        np.testing.assert_array_equal(g.valid.numpy(), (w.row_map >= 0).astype(np.int32))
        assert g.valid.device == g.blocks.device and g.n_actual == w.n_actual


def test_partition_bad_args(pair):
    _, index, carried = pair
    for mod, idx in ((ref_ms, index), (port_ms, carried)):
        for n in (0, idx.n_clusters + 1):
            with pytest.raises(ValueError):
                mod.partition_ivf(idx, n)


@pytest.mark.parametrize("n_groups,b,k,nprobe", [(3, 12, 10, 6), (4, 16, 20, 16), (2, 5, 5, 1), (16, 7, 8, 3)])
def test_routed_search_matches_reference(pair, n_groups, b, k, nprobe):
    emb, index, carried = pair
    q = _corpus(np.random.default_rng(b + nprobe), b, emb.shape[1])
    q[0] = emb[11]  # a corpus row as a query
    want = ref_ms.MultiSliceIVF(index, n_groups).search(q, k=k, nprobe=nprobe)
    ms = port_ms.MultiSliceIVF(carried, n_groups)
    got = ms.search(q, k=k, nprobe=nprobe)
    _assert_same(got, want)
    _assert_same(ms.search(q, k=k, nprobe=nprobe, plain=True), want)
    assert ms.last_failed_groups == [] and ms.last_touched_groups == sorted(ms.last_touched_groups)


def test_vectorized_merge_large_batch_matches_reference(pair):
    emb, index, carried = pair
    q = _corpus(np.random.default_rng(11), 256, emb.shape[1])
    want = ref_ms.MultiSliceIVF(index, 4).search(q, k=20, nprobe=16)
    got = port_ms.MultiSliceIVF(carried, 4).search(q, k=20, nprobe=16)
    _assert_same(got, want)
    # the reference test's invariants, on the port: nprobe 16 probes every
    # cluster, so the single-device search has the same top hit
    v_sd, r_sd = port_ivf.ivf_search(carried, q, 20, nprobe=16)
    assert (got[0][:, 0] >= v_sd[:, 0] - 1e-5).all() and (got[1][:, 0] == r_sd[:, 0]).mean() > 0.99
    assert ((got[1] >= 0) == np.isfinite(got[0])).all()


def test_sharded_groups_match_reference(pair):
    """Two groups, each sharded over 8 CPU slots, against the reference's on
    its 8 virtual devices."""
    emb, index, carried = pair
    q = _corpus(np.random.default_rng(3), 8, emb.shape[1])
    mesh, ref_mesh = make_mesh(n_shards=8, devices=["cpu"] * 8), ref_make_mesh()
    want = ref_ms.MultiSliceIVF(index, 2, meshes=[ref_mesh, ref_mesh]).search(q, k=10, nprobe=6)
    ms = port_ms.MultiSliceIVF(carried, 2, meshes=[mesh, mesh])
    assert all(isinstance(g.index, port_ivf.ShardedIVF) for g in ms.groups)
    _assert_same(ms.search(q, k=10, nprobe=6), want)
    _assert_same(ms.search(q, k=10, nprobe=6, plain=True), want)


def test_self_retrieval_through_routing(pair):
    emb, index, carried = pair
    q = emb[100:116]
    want = ref_ms.MultiSliceIVF(index, 3).search(q, k=1, nprobe=4)
    v, rows = port_ms.MultiSliceIVF(carried, 3).search(q, k=1, nprobe=4)
    _assert_same((v, rows), want)
    assert (rows[:, 0] == np.arange(100, 116)).mean() >= 0.9
    assert v[:, 0] == pytest.approx(np.ones(16), abs=2e-2)


@pytest.mark.parametrize("mod", [ref_ms, port_ms], ids=["reference", "port"])
def test_group_skipping(pair, mod, monkeypatch):
    """A batch whose probes all land in one group touches only it."""
    _, index, carried = pair
    ms = mod.MultiSliceIVF(index if mod is ref_ms else carried, n_groups=4)
    c0 = np.asarray(ms.centroids[0:1], np.float32)
    c0 = c0 / np.linalg.norm(c0)
    calls = []
    orig = mod.SliceGroup.search

    def spy(self, q, k, nprobe, **kw):
        calls.append(self.group_id)
        return orig(self, q, k, nprobe, **kw)

    monkeypatch.setattr(mod.SliceGroup, "search", spy)
    _, rows = ms.search(c0, k=5, nprobe=1)
    assert calls == [0] and (rows[0] >= 0).any()


# -- failure isolation --------------------------------------------------------------


class _RaisingTransport:
    def __init__(self, exc):
        self.exc = exc

    def search(self, q, k, nprobe, **kw):
        raise self.exc

    def close(self):
        pass


@pytest.fixture(scope="module")
def small_pair():
    emb = _corpus(np.random.default_rng(11), 1200, 16)
    index = ref_ivf.build_ivf(emb, n_clusters=8, sample_size=1200, kmeans_iters=3)
    carried = port_ivf.ivf_index_from_arrays(np.asarray(index.centroids), np.asarray(index.blocks), index.row_map,
                                             index.n_actual, device="cpu")
    return _corpus(np.random.default_rng(12), 6, 16), index, carried


def _coordinator(mod, small_pair):
    _, index, carried = small_pair
    return mod.MultiSliceIVF(index if mod is ref_ms else carried, n_groups=2)


@pytest.mark.parametrize("mod,exc", [(ref_ms, ConnectionError("worker unreachable")),
                                     (port_ms, ConnectionError("worker unreachable")),
                                     (port_ms, TimeoutError("timed out")),
                                     (port_ms, port_tr.SliceWorkerGone("exceeded 3 respawns"))],
                         ids=["reference", "port", "port_timeout", "port_respawns_spent"])
def test_gone_worker_is_isolated(small_pair, mod, exc):
    """A gone group degrades recall for its clusters only and is recorded; a
    later healthy batch clears the record."""
    q = small_pair[0]
    ms = _coordinator(mod, small_pair)
    dead_rows = set(ms.groups[1].index.row_map[ms.groups[1].index.row_map >= 0].tolist())
    healthy = ms.transports[1]
    ms.transports[1] = _RaisingTransport(exc)
    v, r = ms.search(q, k=8, nprobe=8)  # probe everything: both groups touched
    assert ms.last_failed_groups == [1]
    live = r[r >= 0]
    assert live.size and not any(int(x) in dead_rows for x in live)
    for row in v:
        fin = row[np.isfinite(row)]
        assert np.all(np.diff(fin) <= 1e-6)
    ms.transports[1] = healthy
    ms.search(q, k=8, nprobe=8)
    assert ms.last_failed_groups == []


@pytest.mark.parametrize("mod", [ref_ms, port_ms], ids=["reference", "port"])
def test_all_groups_gone_raises(small_pair, mod):
    ms = _coordinator(mod, small_pair)
    ms.transports = [_RaisingTransport(ConnectionError("gone")) for _ in ms.transports]
    with pytest.raises(RuntimeError, match="all .* failed"):
        ms.search(small_pair[0], k=4, nprobe=8)


def _error_worker():
    """A live worker that answers every search with ``status: error`` (as a
    worker whose B4 launch failed does); returns (port, close)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    srv.settimeout(0.2)
    stop = threading.Event()

    def answer(conn):
        with conn:
            while True:
                try:
                    port_tr._recv_frame(conn)
                except OSError:
                    return
                port_tr._send_frame(conn, {"status": "error", "error": "ivf_probe: CUDA error 719 at launch"}, {})

    def serve():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            conn.settimeout(None)
            threading.Thread(target=answer, args=(conn,), daemon=True).start()

    t = threading.Thread(target=serve, daemon=True)
    t.start()

    def close():
        stop.set()
        srv.close()
        t.join(timeout=10)

    return srv.getsockname()[1], close


def test_worker_reported_error_raises_in_the_port_and_is_isolated_by_the_reference(small_pair):
    q = small_pair[0]
    port, close = _error_worker()
    try:
        ms = _coordinator(port_ms, small_pair)
        ms.attach_transport(1, port_tr.SocketTransport("127.0.0.1", port, timeout=10))
        with pytest.raises(port_tr.SliceWorkerError, match="CUDA error 719"):
            ms.search(q, k=8, nprobe=8)
        ref = _coordinator(ref_ms, small_pair)
        ref.attach_transport(1, ref_tr.SocketTransport("127.0.0.1", port, timeout=10))
        v, r = ref.search(q, k=8, nprobe=8)  # the reference goes on without the group
        assert ref.last_failed_groups == [1] and (r >= 0).any()
        assert ref.transports[1]._sock is not None  # the reply came: not a timeout
        ms.close()
        ref.close()
    finally:
        close()


def test_in_process_group_error_raises_in_the_port_and_is_isolated_by_the_reference(small_pair, monkeypatch):
    q = small_pair[0]
    for mod in (ref_ms, port_ms):
        ms = _coordinator(mod, small_pair)
        orig = mod.SliceGroup.search

        def failing(self, q, k, nprobe, orig=orig, **kw):
            if self.group_id == 1:
                raise ValueError("probe launch failed")
            return orig(self, q, k, nprobe, **kw)

        monkeypatch.setattr(mod.SliceGroup, "search", failing)
        if mod is port_ms:
            with pytest.raises(ValueError, match="probe launch failed"):
                ms.search(q, k=8, nprobe=8)
        else:
            _, r = ms.search(q, k=8, nprobe=8)
            assert ms.last_failed_groups == [1] and (r >= 0).any()


# A slice worker that dies on the first request it reads, as one whose kernel
# crashes the process does: every respawn dies on the same request again.
_CRASHING_WORKER = """
import os, socket
srv = socket.socket()
srv.bind(("127.0.0.1", 0))
srv.listen(4)
print("PORT", srv.getsockname()[1], flush=True)
conn, _ = srv.accept()
conn.recv(4)
os._exit(3)
"""


@pytest.mark.parametrize("mod,tr", [(ref_ms, ref_tr), (port_ms, port_tr)], ids=["reference", "port"])
def test_request_that_crashes_every_worker(small_pair, monkeypatch, mod, tr):
    """The port raises ``SliceWorkerError`` on each batch whose retry dies
    on a freshly respawned worker, and leaves the group out only once the
    respawn budget is spent; the reference leaves it out from the first
    batch on (ROADMAP C)."""
    q = small_pair[0]
    procs = []

    def spawn(part_path, **kw):
        proc = subprocess.Popen([sys.executable, "-I", "-c", _CRASHING_WORKER], stdout=subprocess.PIPE, text=True)
        procs.append(proc)
        return proc, int(proc.stdout.readline().split()[1])

    monkeypatch.setattr(tr, "spawn_slice_worker", spawn)
    ms = _coordinator(mod, small_pair)
    try:
        st = tr.SupervisedTransport("unused.npz", max_respawns=2)
        ms.attach_transport(1, st)
        if mod is port_ms:
            for n in (1, 2):
                with pytest.raises(port_tr.SliceWorkerError, match="died again on the same request"):
                    ms.search(q, k=8, nprobe=8)
                assert st.respawn_count == n and len(procs) == n + 1
        _, r = ms.search(q, k=8, nprobe=8)  # the reference's first batch; the port's once the budget is spent
        assert ms.last_failed_groups == [1] and (r >= 0).any()
        assert st.respawn_count == (2 if mod is port_ms else 1)
    finally:
        ms.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)
