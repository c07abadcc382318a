"""Cross-process transport for multi-slice IVF groups.

Port of ``tensortruth_tpu/parallel/transport.py``. Above one device's
memory the corpus splits by IVF cluster range across slice groups, the
coordinator host routes query batches, and the scatter and gather cross
processes (or hosts). ``parallel/multislice.py`` implements routing, probe
and merge; THIS module is the transport those steps ride on:

* ``LocalTransport``: an in-process call (single-host deployments, tests).
* ``SocketTransport``: a length-prefixed binary RPC to a ``slice_worker``
  process (``tensortruth_tpu_torch/parallel/slice_worker.py``) that holds
  its cluster range on its own device and probes it with kernel B4.
* ``SupervisedTransport``: spawns the worker, respawns it once per failed
  request when it dies, within a respawn budget.

Wire format (both directions), the reference's byte for byte: a 4-byte
big-endian length, a JSON header, then the raw array payloads named by the
header. Arrays travel as dtype+shape+bytes (numpy on both ends of the wire),
no pickle, so a worker never executes peer-controlled code. One request per
round trip; the socket is kept open across batches. A frame sent by either
package decodes in the other.

A part on disk (``save_ivf_part``) has the reference's npz keys; bf16 blocks
are written as f32 with ``block_dtype="bfloat16"``, so a part written by
either package loads in the other, and bf16 comes back bit for bit.

Errors: a worker that reports ``status: error``, and a request that kills
a supervised worker again right after its respawn (the fault follows the
request), raise :class:`SliceWorkerError`; a supervised worker that cannot
be brought back, or died more often than its respawn budget allows, raises
:class:`SliceWorkerGone`. Both are ``RuntimeError``s. The
coordinator isolates a group only when its worker is gone (an ``OSError``
or :class:`SliceWorkerGone`), never on a failed request (ROADMAP C: a failed
kernel must not cost recall silently).

Workers run on ``cuda`` unless asked for another device; a worker that
cannot place its part there dies on startup, and the spawner raises.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")


class SliceWorkerError(RuntimeError):
    """A request that failed on a slice worker: an error the live worker
    reported (``status: error``), e.g. a kernel that failed to launch, or a
    request that killed its supervised worker and then the worker respawned
    for its retry (e.g. a kernel that crashes the process). The request's
    batch must not go on without it."""


class SliceWorkerGone(RuntimeError):
    """A supervised slice worker that could not be respawned, or died again
    after its respawn budget was spent: its clusters are unreachable."""


def _send_frame(sock: socket.socket, header: dict, arrays: dict[str, np.ndarray]) -> None:
    meta = {
        **header,
        "arrays": {
            name: {"dtype": str(a.dtype), "shape": list(a.shape)}
            for name, a in arrays.items()
        },
    }
    blob = json.dumps(meta).encode()
    sock.sendall(_LEN.pack(len(blob)) + blob)
    for name in meta["arrays"]:
        payload = np.ascontiguousarray(arrays[name]).tobytes()
        sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> tuple[dict, dict[str, np.ndarray]]:
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, n))
    arrays = {}
    for name, spec in header.get("arrays", {}).items():
        (ln,) = _LEN.unpack(_recv_exact(sock, 4))
        data = _recv_exact(sock, ln)
        arrays[name] = np.frombuffer(data, dtype=np.dtype(spec["dtype"])).reshape(
            spec["shape"]
        )
    return header, arrays


class LocalTransport:
    """In-process transport: the group lives in this process. Only it takes
    ``plain`` (the group probes through B4's plain version)."""

    def __init__(self, group):
        self.group = group

    def search(self, q: np.ndarray, k: int, nprobe: int, **kw):
        return self.group.search(q, k, nprobe, **kw)

    def close(self) -> None:
        pass


class SocketTransport:
    """Client side of the slice-worker RPC (one worker per slice group)."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.addr = (host, port)
        self.timeout = timeout
        self._sock: socket.socket | None = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, timeout=self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self._sock

    def search(self, q: np.ndarray, k: int, nprobe: int):
        # Any failure mid-RPC (timeout, partial frame, bad header) leaves the
        # stream position unknown: a late response for THIS request could
        # otherwise be read as the answer to the NEXT one (silently wrong rows
        # at matching shapes). Drop the socket so the next call reconnects on
        # a clean stream.
        sock = self._connect()
        try:
            _send_frame(
                sock,
                {"cmd": "search", "k": int(k), "nprobe": int(nprobe)},
                {"q": np.asarray(q, np.float32)},
            )
            header, arrays = _recv_frame(sock)
        except Exception:
            self.close()
            raise
        if header.get("status") != "ok":
            raise SliceWorkerError(f"slice worker error: {header.get('error')}")
        try:
            return arrays["vals"], arrays["rows"]
        except KeyError:
            self.close()  # malformed ok-response: same desync risk
            raise

    def ping(self) -> bool:
        try:
            sock = self._connect()
            _send_frame(sock, {"cmd": "ping"}, {})
            header, _ = _recv_frame(sock)
            return header.get("status") == "ok"
        except Exception:
            self.close()
            return False

    def shutdown_worker(self) -> None:
        try:
            sock = self._connect()
            _send_frame(sock, {"cmd": "shutdown"}, {})
            _recv_frame(sock)
        except OSError:
            pass
        self.close()

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class SupervisedTransport:
    """Self-healing worker transport: spawn, detect death, respawn.

    Wraps (spawn_slice_worker + SocketTransport) with elastic recovery: a
    transport-level failure (connection refused or reset, mid-frame EOF,
    socket timeout) or a garbled frame kills the worker, respawns it from its
    persisted partition on the same device, and retries the request ONCE. A
    ``status: error`` from a live worker (:class:`SliceWorkerError`) is not a
    respawn trigger: the worker is healthy, the request failed. Nor is a
    retry that fails as the first attempt did: the respawned worker died on
    the same request, so the request raises :class:`SliceWorkerError`.

    ``max_respawns`` bounds total restarts for the transport's lifetime, so a
    crash-looping worker (corrupt partition, out of memory on load) ends in
    :class:`SliceWorkerGone` instead of spinning forever; so does a respawn
    that cannot bring a worker up.
    """

    def __init__(
        self,
        part_path: str | Path,
        cluster_lo: int = 0,
        max_respawns: int = 3,
        startup_timeout: float = 120.0,
        rpc_timeout: float = 120.0,
        env_extra: dict | None = None,
        device: str = "cuda",
        log_path: str | Path | None = None,
    ):
        self.part_path = str(part_path)
        self.cluster_lo = cluster_lo
        self.max_respawns = max_respawns
        self.startup_timeout = startup_timeout
        self.rpc_timeout = rpc_timeout
        self.env_extra = env_extra
        self.device = device
        self.log_path = log_path
        self.respawn_count = 0
        self._proc: subprocess.Popen | None = None
        self._inner: SocketTransport | None = None
        self._spawn()

    def _spawn(self) -> None:
        self._proc, port = spawn_slice_worker(
            self.part_path,
            cluster_lo=self.cluster_lo,
            startup_timeout=self.startup_timeout,
            env_extra=self.env_extra,
            device=self.device,
            log_path=self.log_path,
        )
        self._inner = SocketTransport("127.0.0.1", port, timeout=self.rpc_timeout)

    def _respawn(self, cause: BaseException) -> None:
        if self.respawn_count >= self.max_respawns:
            raise SliceWorkerGone(
                f"slice worker for {self.part_path} exceeded "
                f"{self.max_respawns} respawns (last error: {cause})"
            ) from cause
        self.respawn_count += 1
        logger.warning(
            "slice worker died (%s) — respawn %d/%d from %s",
            cause, self.respawn_count, self.max_respawns, self.part_path,
        )
        self._kill()
        try:
            self._spawn()
        except Exception as e:
            raise SliceWorkerGone(
                f"slice worker for {self.part_path} could not be respawned: {e}"
            ) from e

    def _kill(self) -> None:
        if self._inner is not None:
            self._inner.close()
            self._inner = None
        if self._proc is not None:
            if self._proc.poll() is None:
                self._proc.kill()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            self._proc = None

    def search(self, q: np.ndarray, k: int, nprobe: int):
        try:
            return self._inner.search(q, k, nprobe)
        except RuntimeError:
            # status:error from a LIVE worker: the request failed, not the
            # worker; respawning would just replay it.
            raise
        except Exception as e:
            # OSError (refused/reset/timeout/mid-frame EOF) and protocol
            # corruption (json/struct/KeyError on a garbled frame) both mean
            # the worker or its stream is unusable: respawn and retry once.
            self._respawn(e)
        try:
            return self._inner.search(q, k, nprobe)
        except RuntimeError:
            raise
        except Exception as e:
            # The fresh worker died on the same request: the request is at
            # fault, not the worker, and the group must not be left out.
            raise SliceWorkerError(
                f"slice worker for {self.part_path} died again on the same "
                f"request after a respawn: {e!r}"
            ) from e

    def ping(self) -> bool:
        return self._inner is not None and self._inner.ping()

    @property
    def worker_pid(self) -> int | None:
        return self._proc.pid if self._proc is not None else None

    def close(self) -> None:
        if self._inner is not None:
            self._inner.shutdown_worker()
        self._kill()


def save_ivf_part(index, path: str | Path) -> None:
    """Persist one IVF partition (an ``ops/ivf.py::IVFIndex``) for a worker
    process: an npz with the reference's keys, no pickle.

    bf16 blocks have no numpy dtype, so they travel as f32 with the original
    dtype recorded and restored at load (value-exact: every bf16 is exactly
    representable in f32)."""
    import torch

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blocks = index.blocks
    block_dtype = str(blocks.dtype).removeprefix("torch.")
    if blocks.dtype == torch.bfloat16:
        blocks = blocks.float()
    arrays = {
        "centroids": index.centroids.float().cpu().numpy(),
        "blocks": blocks.cpu().numpy(),
        "block_dtype": np.asarray(block_dtype),
        "row_map": np.asarray(index.row_map),
        "n_actual": np.asarray(index.n_actual),
    }
    if index.scales is not None:
        arrays["scales"] = index.scales.float().cpu().numpy()
    np.savez(path, **arrays)


def load_ivf_part(path: str | Path, device="cuda"):
    """Load a partition saved by ``save_ivf_part`` (by either package) as an
    ``IVFIndex`` placed on ``device``; bf16 blocks come back bit for bit."""
    import torch

    from tensortruth_tpu_torch.ops.ivf import ivf_index_from_arrays

    with np.load(Path(path)) as z:
        blocks = torch.from_numpy(z["blocks"])
        block_dtype = str(z["block_dtype"]) if "block_dtype" in z.files else ""
        if block_dtype == "bfloat16":
            blocks = blocks.to(torch.bfloat16)
        return ivf_index_from_arrays(
            z["centroids"], blocks, z["row_map"], int(z["n_actual"]),
            scales=z["scales"] if "scales" in z.files else None, device=device,
        )


def spawn_slice_worker(
    part_path: str | Path,
    port: int = 0,
    cluster_lo: int = 0,
    startup_timeout: float = 120.0,
    env_extra: dict | None = None,
    device: str = "cuda",
    log_path: str | Path | None = None,
) -> tuple[subprocess.Popen, int]:
    """Start a slice-worker subprocess serving ``part_path`` on ``device``;
    returns (process, bound_port). ``port=0`` lets the worker pick a free
    port and report it on stdout (``PORT <n>`` line). The worker's standard
    error goes to ``log_path`` (appended), else it is discarded. A worker
    that cannot place its part on ``device`` dies on startup, and this
    raises."""
    import os

    import tensortruth_tpu_torch

    env = dict(os.environ)
    # make the package importable regardless of the spawner's cwd
    pkg_root = str(Path(tensortruth_tpu_torch.__file__).resolve().parent.parent)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    stderr = open(log_path, "a") if log_path is not None else subprocess.DEVNULL
    try:
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "tensortruth_tpu_torch.parallel.slice_worker",
                "--part",
                str(part_path),
                "--port",
                str(port),
                "--cluster-lo",
                str(cluster_lo),
                "--device",
                str(device),
            ],
            stdout=subprocess.PIPE,
            stderr=stderr,
            env=env,
            text=True,
        )
    finally:
        if log_path is not None:
            stderr.close()  # the child holds its own descriptor
    # A blocking readline() would ignore the deadline when the worker hangs
    # without producing output (e.g. stuck device init): read from a daemon
    # thread so the timeout is enforced no matter what the child does.
    import queue as queue_mod
    import threading

    lines: queue_mod.Queue = queue_mod.Queue()
    port_found = threading.Event()

    def _reader():
        # After the port is known the thread keeps DRAINING the pipe (so a
        # chatty worker never blocks on a full stdout buffer) but discards
        # the lines: queueing them for the worker's lifetime would grow
        # memory without bound, since nobody reads the queue after startup.
        for line in proc.stdout:
            if not port_found.is_set():
                lines.put(line)
        lines.put(None)  # EOF

    threading.Thread(target=_reader, daemon=True).start()
    deadline = time.monotonic() + startup_timeout
    bound = None
    while bound is None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            line = lines.get(timeout=min(0.25, remaining))
        except queue_mod.Empty:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"slice worker died on startup (rc={proc.returncode})"
                )
            continue
        if line is None:  # stdout closed: the worker is exiting, or has
            try:
                proc.wait(timeout=min(5.0, max(remaining, 0.1)))
            except subprocess.TimeoutExpired:
                pass
            if proc.poll() is not None:
                raise RuntimeError(
                    f"slice worker died on startup (rc={proc.returncode})"
                )
            break
        if line.startswith("PORT "):
            bound = int(line.split()[1])
            port_found.set()
    if bound is None:
        proc.kill()
        raise TimeoutError("slice worker did not report its port in time")
    return proc, bound
