"""Slice-group worker process: serves one IVF cluster range over a socket.

``python -m tensortruth_tpu_torch.parallel.slice_worker --part part.npz
--device cuda:0 --port 0`` loads the partition (``parallel/transport.py``
``save_ivf_part`` format, written by either package) onto ``--device``
(default ``cuda``), binds a TCP port on 127.0.0.1 (0 = ephemeral; the bound
port is announced as ``PORT <n>`` on stdout for the spawner), and answers
``ping`` / ``search`` / ``shutdown`` RPCs until ``shutdown``.

This is the process side of the multislice tier: the coordinator
(``parallel/multislice.py::MultiSliceIVF``) routes batches to workers over
these sockets, and each worker probes its clusters with ``ops/ivf.py``
(kernel B4 on a CUDA device; the kernels are built or loaded through
``_build.py`` as in any process of the package). One request at a time per
connection. A search that raises is reported as ``status: error`` and the
worker goes on serving; the coordinator raises on that report. The worker's
standard error names the part, the device and the seconds the load took.
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

import numpy as np


def serve(part_path: str, port: int, cluster_lo: int = 0, device: str = "cuda") -> None:
    from tensortruth_tpu_torch.parallel.multislice import SliceGroup
    from tensortruth_tpu_torch.parallel.transport import (
        _recv_frame,
        _send_frame,
        load_ivf_part,
    )

    t0 = time.perf_counter()
    group = SliceGroup(
        group_id=0, cluster_lo=cluster_lo, index=load_ivf_part(part_path, device=device)
    )
    print(f"loaded {part_path} onto {device} in {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(4)
    print(f"PORT {srv.getsockname()[1]}", flush=True)

    running = True
    while running:
        conn, _ = srv.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                try:
                    header, arrays = _recv_frame(conn)
                except (ConnectionError, OSError):
                    break
                cmd = header.get("cmd")
                if cmd == "ping":
                    _send_frame(conn, {"status": "ok"}, {})
                elif cmd == "shutdown":
                    _send_frame(conn, {"status": "ok"}, {})
                    running = False
                    break
                elif cmd == "search":
                    try:
                        vals, rows = group.search(
                            arrays["q"], k=int(header["k"]),
                            nprobe=int(header["nprobe"]),
                        )
                        _send_frame(
                            conn,
                            {"status": "ok"},
                            {
                                "vals": np.asarray(vals, np.float32),
                                "rows": np.asarray(rows, np.int64),
                            },
                        )
                    except Exception as e:  # report, keep serving
                        _send_frame(conn, {"status": "error", "error": str(e)}, {})
                else:
                    _send_frame(
                        conn, {"status": "error", "error": f"unknown cmd {cmd}"}, {}
                    )
        finally:
            conn.close()
    srv.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--part", required=True, help="npz partition path")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--cluster-lo", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device to hold the part on (default: cuda)")
    args = ap.parse_args(argv)
    serve(args.part, args.port, args.cluster_lo, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
