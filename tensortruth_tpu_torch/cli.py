"""CLI entry points (reference cli.py + pyproject entry points).

``tensor-truth-tpu``        → API server (aiohttp)
``tensor-truth-tpu-build``  → offline index build (build_db.py)
"""

from __future__ import annotations

import argparse


def main() -> None:
    parser = argparse.ArgumentParser(description="TensorTruth-TPU server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args()
    from tensortruth_tpu_torch.server.app import run

    run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
