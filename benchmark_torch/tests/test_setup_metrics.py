"""The five readers of the program's set-up account (``harness/setup_parts.py``,
``metrics/setup_*.py``), on the CPU:

    python -m pytest benchmark_torch/tests/test_setup_metrics.py -q

* from synthetic statuses each reader gives the number its docstring
  defines, and None for a program whose status has no ``setup`` entry;
* a traced ``--tiny`` rehearsal of each cell prints all five, each at least
  0, with engine, served and other summing to that run's ``setup_s``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FIVE = ["setup_engine_s", "setup_index_s", "setup_models_s", "setup_served_s", "setup_other_s"]
CELLS = next(m for m in BENCH["per_layer"] if m["name"] == FIVE[0])["workloads"]

sys.path.insert(0, str(ROOT))


def read(name, before, setup_s=30.0):
    from benchmark_torch.harness import chat

    return chat.load_metric(name).read(SimpleNamespace(setup_s=setup_s, batcher={"before": before, "after": {}}))


def test_readers_on_synthetic_statuses():
    setup = {"engine_s": 6.0, "engine_busy_s": 5.5, "index_read_s": 0.5, "models_s": 2.5, "busy_s": 17.5,
             "messages": 190, "sessions": 300}
    before = {"batches_run": 40, "requests_served": 190, "setup": setup}
    got = {name: read(name, before) for name in FIVE}
    assert got == {"setup_engine_s": 6.0, "setup_index_s": 0.5, "setup_models_s": 2.5, "setup_served_s": 12.0,
                   "setup_other_s": 12.0}
    assert got["setup_engine_s"] + got["setup_served_s"] + got["setup_other_s"] == 30.0
    for before in ({"batches_run": 40, "requests_served": 190}, {}):  # a program without the account
        for name in FIVE:
            assert read(name, before) is None, name


@pytest.mark.parametrize("cell", CELLS)
def test_traced_tiny_rehearsal_prints_the_five(cell):
    code = (
        "import json, sys, time; sys.path.insert(0, %r)\n"
        "from benchmark_torch.harness import chat\n"
        "from benchmark_torch.harness.common import load_cell\n"
        "r = chat.run(load_cell(%r), 2**31 + 77, 4.0, True, time.time(), tiny=True)\n"
        "print(json.dumps(r))\n" % (str(ROOT), cell)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    info = json.loads(next(line[5:] for line in out.stderr.splitlines() if line.startswith("info ")))
    got = {name: r["metrics"][name]["value"] for name in FIVE}
    assert all(v >= 0 for v in got.values()), got
    assert got["setup_engine_s"] + got["setup_served_s"] + got["setup_other_s"] == pytest.approx(
        info["setup_s"], abs=0.05)
    assert got["setup_index_s"] + got["setup_models_s"] <= got["setup_engine_s"]
    setup = info["batcher"]["before"]["setup"]
    assert setup["engine_n"] == 1 and setup["messages"] >= 1 and setup["sessions"] >= 1
