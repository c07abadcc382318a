#!/usr/bin/env python3
"""One cell of the PyTorch port's benchmark.

    python3 benchmark_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA cards the cell asks
for. The cell (``BENCHMARK.json``) names a configuration
(``benchmark_torch/configs/<name>.json``) and a traffic mix
(``benchmark_torch/traffic/<name>.json``); each metric it reports is read by
``benchmark_torch/metrics/<name>.py``. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared with the reference beside its limit); the same checks are
the last lines of standard error.

``--tiny`` rehearses the cell on the CPU at the port's test sizes (tiny
models, a few thousand leaves); it is never a measurement.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

try:
    import psutil

    T_START = psutil.Process().create_time()
except ImportError:  # the process's first line is the next best start
    T_START = time.time()

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tiny", action="store_true", help="CPU rehearsal at test sizes (no measurement)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark_torch.harness.common import load_cell, set_cache_env

    set_cache_env()  # before CUDA or any compiler starts
    from benchmark_torch.harness import chat

    cell = load_cell(args.workload)
    if not args.tiny:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 3
    result = chat.run(cell, args.seed, args.seconds, bool(args.trace), T_START, tiny=args.tiny)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
