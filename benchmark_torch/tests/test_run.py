"""The run's last look before it prints a result, on the CPU:

    python -m pytest benchmark_torch/tests/test_run.py -q

* a run whose process has JAX, jaxlib, flax or the JAX package loaded once
  the window has closed prints no result, exits non-zero and names what it
  found; the port's own package, whose name begins with the JAX package's,
  is not among them;
* so does a whole CPU rehearsal of a cell with the JAX package planted
  before it starts.
"""

from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark_torch import run  # noqa: E402
from benchmark_torch.harness import chat, common  # noqa: E402

CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
ARGS = ["--workload", CELL, "--seed", "3000000001", "--seconds", "1", "--tiny"]
RESULT = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}, "checks": {}}


@pytest.fixture
def no_window(monkeypatch):
    """``run.main`` with the window replaced by a fixed result and with no
    forbidden module loaded beforehand."""
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(common, "set_cache_env", lambda: None)
    monkeypatch.setattr(chat, "run", lambda *a, **k: dict(RESULT))


def test_clean_process_prints_its_result(no_window, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "tensortruth_tpu_torch_probe", types.ModuleType("tensortruth_tpu_torch_probe"))
    if "tensortruth_tpu_torch" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensortruth_tpu_torch", types.ModuleType("tensortruth_tpu_torch"))
    assert run.main(ARGS) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == RESULT


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax.linen", "tensortruth_tpu",
                                  "tensortruth_tpu.ops.topk"])
def test_forbidden_module_no_result(no_window, monkeypatch, capsys, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.main(ARGS) != 0
    out = capsys.readouterr()
    assert not out.out.strip()
    assert name.split(".")[0] in out.err and "no result" in out.err


def test_rehearsal_with_the_jax_package_loaded_no_result():
    code = ("import runpy, sys, types\n"
            "sys.modules['tensortruth_tpu'] = types.ModuleType('tensortruth_tpu')\n"
            "sys.argv = ['run.py'] + %r\n"
            "runpy.run_path('benchmark_torch/run.py', run_name='__main__')\n" % (ARGS[:-2] + ["4", "--tiny"]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode != 0 and not out.stdout.strip(), out.stderr[-3000:]
    assert "check selection_faults" in out.stderr  # the window ran and was judged
    assert "no result: the process has loaded tensortruth_tpu" in out.stderr
