"""The port's socket transport and slice worker
(tensortruth_tpu_torch/parallel/{transport,slice_worker}.py) against the
reference's, on the CPU.

* The wire is the reference's byte for byte: a frame sent by either
  package decodes in the other, over a socketpair.
* A part saved by either package loads in the other (the reference's npz
  keys; bf16 blocks as f32 with ``block_dtype``), with the bf16 bits equal;
  ``load_ivf_part`` places the part on the device it is given and defaults
  to ``cuda``, which raises here.
* The cross-process search through the port's worker on ``device="cpu"``:
  the ids of the all-local search, rows from the remote group among them;
  one SIGKILL respawn; the respawn budget running out; a worker spawned on
  the default device (``cuda``) dies on startup here, and the spawner raises
  instead of serving on the CPU.
* The client side's guards, as the reference's tests hold them: a dead port
  fails loudly, a garbled reply drops the socket, a garbled frame respawns a
  supervised worker and a reported error does not, and a failed RPC leaves
  the worker's connection usable.

Every spawned worker starts with a 60 s startup timeout and is killed in a
``finally``.
"""

import signal
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensortruth_tpu.ops import ivf as ref_ivf
from tensortruth_tpu.parallel import transport as ref_tr
from tensortruth_tpu_torch.ops import ivf as port_ivf
from tensortruth_tpu_torch.parallel import slice_worker
from tensortruth_tpu_torch.parallel import transport as port_tr
from tensortruth_tpu_torch.parallel.multislice import MultiSliceIVF, SliceGroup

torch.set_num_threads(1)

STARTUP_S = 60
WORKER_ENV = {"OMP_NUM_THREADS": "1"}


def _corpus(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port_index(n, d, n_clusters, seed, block_dtype=torch.bfloat16):
    emb = _corpus(np.random.default_rng(seed), n, d)
    return emb, port_ivf.build_ivf(emb, n_clusters=n_clusters, sample_size=n, kmeans_iters=3,
                                   block_dtype=block_dtype, device="cpu")


def _bits(blocks) -> np.ndarray:
    """Block bits as integers, for either package's bf16 / int8 arrays."""
    if torch.is_tensor(blocks):
        return (blocks.view(torch.int16) if blocks.dtype == torch.bfloat16 else blocks).numpy()
    blocks = np.asarray(blocks)
    return blocks.view(np.int16) if blocks.dtype.name == "bfloat16" else blocks


@pytest.mark.parametrize("sender,receiver", [(ref_tr, port_tr), (port_tr, ref_tr)], ids=["ref_to_port", "port_to_ref"])
def test_frame_crosses_packages(sender, receiver):
    a, b = socket.socketpair()
    try:
        arrays = {"q": np.arange(12, dtype=np.float32).reshape(3, 4), "ids": np.array([[1, -1]], dtype=np.int64),
                  "empty": np.zeros((0, 5), np.float32)}
        t = threading.Thread(target=lambda: sender._send_frame(a, {"cmd": "search", "k": 5}, arrays))
        t.start()
        header, got = receiver._recv_frame(b)
        t.join()
        assert header["cmd"] == "search" and header["k"] == 5
        for name, want in arrays.items():
            assert got[name].dtype == want.dtype and got[name].shape == want.shape
            np.testing.assert_array_equal(got[name], want)
    finally:
        a.close()
        b.close()


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def both_indexes(request):
    """(reference index, the port's copy of it on the CPU)."""
    emb = _corpus(np.random.default_rng(3), 600, 16)
    dtype = jnp.int8 if request.param == "int8" else jnp.bfloat16
    index = ref_ivf.build_ivf(emb, n_clusters=8, sample_size=600, kmeans_iters=3, block_dtype=dtype)
    scales = None if index.scales is None else np.asarray(index.scales)
    carried = port_ivf.ivf_index_from_arrays(np.asarray(index.centroids), np.asarray(index.blocks), index.row_map,
                                             index.n_actual, scales=scales, device="cpu")
    return index, carried


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_part_saved_by_one_package_loads_in_the_other(both_indexes, writer, tmp_path):
    ref_index, port_index = both_indexes
    path = tmp_path / "part.npz"
    if writer == "reference":
        ref_tr.save_ivf_part(ref_index, path)
        loaded = port_tr.load_ivf_part(path, device="cpu")
        assert loaded.blocks.dtype == port_index.blocks.dtype and loaded.blocks.device.type == "cpu"
    else:
        port_tr.save_ivf_part(port_index, path)
        loaded = ref_tr.load_ivf_part(path)
        assert np.asarray(loaded.blocks).dtype == np.asarray(ref_index.blocks).dtype
    with np.load(path) as z:
        assert sorted(z.files) == sorted(["centroids", "blocks", "block_dtype", "row_map", "n_actual"]
                                         + (["scales"] if ref_index.scales is not None else []))
        assert str(z["block_dtype"]) == str(np.asarray(ref_index.blocks).dtype)
        assert z["blocks"].dtype == (np.int8 if ref_index.scales is not None else np.float32)
    np.testing.assert_array_equal(_bits(loaded.blocks), _bits(ref_index.blocks))
    np.testing.assert_array_equal(np.asarray(loaded.row_map), ref_index.row_map)
    np.testing.assert_array_equal(np.asarray(loaded.centroids, np.float32) if writer == "port"
                                  else loaded.centroids.numpy(), np.asarray(ref_index.centroids))
    assert loaded.n_actual == ref_index.n_actual
    if ref_index.scales is not None:
        got = np.asarray(loaded.scales) if writer == "port" else loaded.scales.numpy()
        np.testing.assert_array_equal(got, np.asarray(ref_index.scales))


def test_load_ivf_part_honours_device(both_indexes, tmp_path):
    _, port_index = both_indexes
    port_tr.save_ivf_part(port_index, tmp_path / "part.npz")
    loaded = port_tr.load_ivf_part(tmp_path / "part.npz", device="cpu")
    tensors = [loaded.centroids, loaded.blocks, loaded.valid] + ([loaded.scales] if loaded.scales is not None else [])
    assert all(t.device == torch.device("cpu") for t in tensors)
    np.testing.assert_array_equal(loaded.valid.numpy(), (port_index.row_map >= 0).astype(np.int32))
    assert not torch.cuda.is_available()
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        port_tr.load_ivf_part(tmp_path / "part.npz")  # the default device is cuda


def test_search_crosses_process_boundary(tmp_path):
    """Group 1 is served by the port's worker on the CPU over a socket; the
    coordinator's local copy is dropped, and the ids must equal the all-local
    coordinator's, rows of the remote group among them."""
    emb, index = _port_index(4000, 32, 16, seed=7)
    q = _corpus(np.random.default_rng(8), 16, 32)
    k, nprobe = 10, 16  # probe everything: both groups touched

    local = MultiSliceIVF(index, n_groups=2)
    v_ref, r_ref = local.search(q, k=k, nprobe=nprobe)
    remote = MultiSliceIVF(index, n_groups=2)
    remote.save_part(1, tmp_path / "g1.npz")
    proc, port = port_tr.spawn_slice_worker(tmp_path / "g1.npz", cluster_lo=remote.groups[1].cluster_lo,
                                            startup_timeout=STARTUP_S, env_extra=WORKER_ENV, device="cpu")
    try:
        t = port_tr.SocketTransport("127.0.0.1", port)
        assert t.ping()
        remote.attach_transport(1, t)
        assert remote.groups[1].index is None
        v, r = remote.search(q, k=k, nprobe=nprobe)
        np.testing.assert_array_equal(r, r_ref)
        np.testing.assert_allclose(v, v_ref, rtol=1e-4, atol=1e-5)
        remote_rows = set(local.groups[1].index.row_map[local.groups[1].index.row_map >= 0].tolist())
        assert any(int(x) in remote_rows for x in r.ravel() if x >= 0)
        assert remote.last_failed_groups == [] and remote.last_touched_groups == [0, 1]
        _, r2 = remote.search(q[:4], k=k, nprobe=nprobe)  # the same connection again
        np.testing.assert_array_equal(r2, r_ref[:4])
        t.shutdown_worker()
        proc.wait(timeout=30)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        local.close()
        remote.close()


def test_supervised_transport_respawns_after_sigkill(tmp_path):
    _, index = _port_index(800, 16, 4, seed=13)
    port_tr.save_ivf_part(index, tmp_path / "p.npz")
    q = _corpus(np.random.default_rng(14), 4, 16)
    v_ref, r_ref = SliceGroup(0, 0, index).search(q, k=6, nprobe=4)
    st = port_tr.SupervisedTransport(tmp_path / "p.npz", startup_timeout=STARTUP_S, env_extra=WORKER_ENV,
                                     device="cpu")
    try:
        v, r = st.search(q, k=6, nprobe=4)
        np.testing.assert_array_equal(r, r_ref)
        np.testing.assert_array_equal(v, v_ref)
        pid_before = st.worker_pid
        st._proc.send_signal(signal.SIGKILL)
        st._proc.wait(timeout=30)
        v2, r2 = st.search(q, k=6, nprobe=4)  # respawn + retry, the same answer
        np.testing.assert_array_equal(r2, r_ref)
        np.testing.assert_array_equal(v2, v)
        assert st.respawn_count == 1 and st.worker_pid != pid_before and st.ping()
    finally:
        st.close()
    assert st.worker_pid is None


def test_supervised_transport_respawn_budget_exhausts(tmp_path):
    _, index = _port_index(400, 16, 4, seed=15)
    port_tr.save_ivf_part(index, tmp_path / "p.npz")
    st = port_tr.SupervisedTransport(tmp_path / "p.npz", max_respawns=0, startup_timeout=STARTUP_S,
                                     env_extra=WORKER_ENV, device="cpu")
    try:
        st._proc.kill()
        st._proc.wait(timeout=30)
        with pytest.raises(port_tr.SliceWorkerGone, match="exceeded 0 respawns"):
            st.search(_corpus(np.random.default_rng(16), 2, 16), k=4, nprobe=2)
    finally:
        st.close()


def test_worker_on_the_default_device_dies_without_a_card(tmp_path):
    """``cuda`` is the default; with no card the worker cannot place its part
    and exits, and the spawner raises: no quiet fallback to the CPU."""
    _, index = _port_index(400, 16, 4, seed=17)
    port_tr.save_ivf_part(index, tmp_path / "p.npz")
    log = tmp_path / "worker.log"
    proc = None
    try:
        with pytest.raises(RuntimeError, match="died on startup"):
            proc, _ = port_tr.spawn_slice_worker(tmp_path / "p.npz", startup_timeout=STARTUP_S, env_extra=WORKER_ENV,
                                                 log_path=log)
        assert "CUDA" in log.read_text()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()


def test_worker_error_rpc_keeps_connection_usable(tmp_path):
    """A failed search is reported as ``status: error`` and the same
    connection serves the next request; the client raises SliceWorkerError
    on the report."""
    _, index = _port_index(400, 16, 4, seed=1)
    port_tr.save_ivf_part(index, tmp_path / "p.npz")
    ready, holder = threading.Event(), {}

    class PortSniffer:
        def write(self, s):
            if s.startswith("PORT "):
                holder["port"] = int(s.split()[1])
                ready.set()
            return len(s)

        def flush(self):
            pass

    import contextlib

    def run():
        with contextlib.redirect_stdout(PortSniffer()):
            slice_worker.serve(str(tmp_path / "p.npz"), 0, device="cpu")

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(60)
    tr = port_tr.SocketTransport("127.0.0.1", holder["port"])
    sock = tr._connect()
    port_tr._send_frame(sock, {"cmd": "search", "k": 5, "nprobe": 2}, {})  # no q array
    header, _ = port_tr._recv_frame(sock)
    assert header["status"] == "error"
    with pytest.raises(port_tr.SliceWorkerError, match="slice worker error"):
        tr.search(np.zeros((1, 8), np.float32), k=5, nprobe=2)  # a query of the wrong width
    vals, rows = tr.search(_corpus(np.random.default_rng(2), 2, 16), k=5, nprobe=2)
    assert vals.shape == (2, 5) and rows.shape == (2, 5)
    tr.shutdown_worker()
    t.join(timeout=30)
    assert not t.is_alive()


def test_socket_transport_error_reporting():
    t = port_tr.SocketTransport("127.0.0.1", 1, timeout=2)
    assert t.ping() is False
    with pytest.raises(OSError):
        t.search(np.zeros((1, 4), np.float32), k=1, nprobe=1)


def test_socket_transport_resets_socket_after_rpc_failure():
    """A garbled reply (an ok-frame with no arrays) raises and drops the
    socket; the reconnect reads a clean stream."""
    calls = {"n": 0}
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)

    def serve():
        for _ in range(2):
            conn, _ = srv.accept()
            with conn:
                port_tr._recv_frame(conn)
                calls["n"] += 1
                arrays = {} if calls["n"] == 1 else {"vals": np.zeros((1, 2), np.float32),
                                                     "rows": np.zeros((1, 2), np.int64)}
                port_tr._send_frame(conn, {"status": "ok"}, arrays)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    tr = port_tr.SocketTransport("127.0.0.1", srv.getsockname()[1], timeout=10)
    q = np.zeros((1, 4), np.float32)
    with pytest.raises(KeyError):
        tr.search(q, k=2, nprobe=1)
    assert tr._sock is None
    vals, rows = tr.search(q, k=2, nprobe=1)
    assert vals.shape == (1, 2) and rows.shape == (1, 2)
    tr.close()
    srv.close()
    t.join(timeout=10)


def test_supervised_transport_respawns_on_garbage_not_on_reported_errors(monkeypatch):
    import json

    spawned = []

    class FakeInner:
        def __init__(self, fail_with):
            self.fail_with = fail_with

        def search(self, q, k, nprobe):
            if self.fail_with is not None:
                e, self.fail_with = self.fail_with, None
                raise e
            return np.zeros((1, k), np.float32), np.zeros((1, k), np.int64)

        def close(self):
            pass

    def fake_spawn(self):
        inner = FakeInner(json.JSONDecodeError("garbage", "x", 0) if not spawned else None)
        spawned.append(inner)
        self._proc, self._inner = None, inner

    monkeypatch.setattr(port_tr.SupervisedTransport, "_spawn", fake_spawn)
    tr = port_tr.SupervisedTransport("unused.npz", max_respawns=2)
    vals, _ = tr.search(np.zeros((1, 4), np.float32), k=3, nprobe=1)
    assert vals.shape == (1, 3) and len(spawned) == 2
    spawned[1].fail_with = port_tr.SliceWorkerError("slice worker error: kernel launch failed")
    with pytest.raises(port_tr.SliceWorkerError):
        tr.search(np.zeros((1, 4), np.float32), k=3, nprobe=1)
    assert len(spawned) == 2 and tr.respawn_count == 1


def test_supervised_transport_that_cannot_respawn_is_gone(monkeypatch):
    """A respawn whose worker dies on startup makes the worker gone
    (``SliceWorkerGone``, which the coordinator isolates), not a request
    error."""
    spawned = []

    class DeadInner:
        def search(self, q, k, nprobe):
            raise ConnectionResetError("worker died")

        def close(self):
            pass

    def fake_spawn(self):
        if spawned:
            raise RuntimeError("slice worker died on startup (rc=1)")
        spawned.append(1)
        self._proc, self._inner = None, DeadInner()

    monkeypatch.setattr(port_tr.SupervisedTransport, "_spawn", fake_spawn)
    tr = port_tr.SupervisedTransport("unused.npz", max_respawns=3)
    with pytest.raises(port_tr.SliceWorkerGone, match="could not be respawned.*died on startup"):
        tr.search(np.zeros((1, 4), np.float32), k=3, nprobe=1)
    assert tr.respawn_count == 1


def test_multislice_close_closes_all_transports():
    _, index = _port_index(600, 16, 8, seed=2)
    ms = MultiSliceIVF(index, n_groups=2)
    closed = []
    for i, t in enumerate(ms.transports):
        orig = t.close
        t.close = (lambda i=i, orig=orig: (closed.append(i), orig())[1])
    ms.close()
    assert closed == [0, 1]
