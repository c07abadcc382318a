"""The benchmark's own tests, at the port's test sizes on the CPU:

    python -m pytest benchmark_torch/tests -q

* the control (the reference in the program's place at float8 e4m3) fails
  a limit of every configuration;
* a sound rehearsal of a cell is correct, and the same run with the timed
  path broken underneath is not: every rerank score altered where it is
  produced, half of each rerank batch left out (given the mean of the
  other half), and each query's sources handed back in ascending order;
* each open-loop mix runs at its stated share of the knee swept for the
  cell that uses it;
* the closed-loop cell kept out of BENCHMARK.json still rehearses, correct
  when sound and not with an altered score;
* without a card, or without the program beside it, a run exits non-zero
  and prints no result;
* every configuration, mix and metric that BENCHMARK.json names has its
  file, and every metric's reader finds nothing to read in an empty run.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]

sys.path.insert(0, str(ROOT))


def rehearse(cell: str, seed: int, fault: str | None = None, bench_file: Path | None = None) -> dict:
    """One CPU rehearsal of ``cell`` in its own interpreter (the run patches
    the program's classes for the life of its process)."""
    code = (
        "import json, sys, time; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from benchmark_torch.harness import chat\n"
        "from benchmark_torch.harness.common import load_cell\n"
        "r = chat.run(load_cell(%r, Path(%r)), %d, 4.0, False, time.time(), tiny=True, fault=%r)\n"
        "print(json.dumps(r))\n" % (str(ROOT), cell, str(bench_file or ROOT / "BENCHMARK.json"), seed, fault)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("config_name", CONFIGS)
def test_control_fails_a_limit(config_name):
    import torch

    from benchmark_torch.harness import chat, check, traffic
    from benchmark_torch.harness.common import load_json
    from benchmark_torch.harness.corpus import Texts

    entry = next(c for c in BENCH["configs"] if c["name"] == config_name)
    config = chat.tiny_config(load_json(ROOT / entry["file"]))
    spec = next(json.loads((ROOT / "benchmark_torch" / "traffic" / f"{w['traffic']}.json").read_text())
                for w in BENCH["workloads"] if w["config"] == config_name)
    texts = Texts(config["corpus"])
    for seed in (11, 12, 13):
        queries = traffic.queries(texts.pool, traffic.lengths(spec, 48, seed), seed)
        ref = check.Reference(config, seed, torch.device("cpu"))
        ctrl = check.Reference(config, seed, torch.device("cpu"), precision="fp8")
        numbers, _ = check.compare(check.control_records(queries, ctrl), ref, not chat.is_ivf(config))
        ok, shown = check.verdict(numbers, config["limits"])
        assert not ok, shown


@pytest.mark.parametrize("cell", CELLS)
def test_sound_rehearsal_is_correct(cell):
    r = rehearse(cell, 21)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["score", "half", "reverse"])
def test_broken_path_is_not_correct(cell, fault):
    r = rehearse(cell, 22, fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if json.loads(
    (ROOT / "benchmark_torch" / "traffic" / f"{w['traffic']}.json").read_text())["generator"] == "open_loop"])
def test_open_loop_rate_is_its_share_of_its_knee(cell):
    work = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = json.loads((ROOT / "benchmark_torch" / "traffic" / f"{work['traffic']}.json").read_text())
    assert cell in spec["why"], "the mix's knee was swept for another cell"
    assert spec["rate_per_s"] == round(spec["rate_share_of_knee"] * spec["knee_per_s"] * 2) / 2


# The closed-loop cell left out of BENCHMARK.json until its runs hold steady
# (PERF.md): its mix and readers stay, rehearsed here as the cell would be.
SATURATED = {
    "workload": {"name": "flat1m.chat-saturated", "config": "bge-m3.flat-1m", "traffic": "chat-saturated",
                 "chips": 1, "why": "closed loop"},
    "end_to_end": [{"name": "answered_per_s", "unit": "msg/s", "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": ["flat1m.chat-saturated"]}],
    "per_layer": [{"name": name, "unit": unit, "better": better, "source": "device_trace", "layer": "x",
                   "moves": "answered_per_s", "workloads": ["flat1m.chat-saturated"]}
                  for name, unit, better in (("mean_batch.saturated", "req/batch", "higher"),
                                             ("serve_mfu.saturated", "%", "higher"),
                                             ("device_idle_pct.saturated", "%", "lower"))],
}


@pytest.mark.parametrize("fault", [None, "score"])
def test_closed_loop_rehearsal(tmp_path, fault):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(SATURATED["workload"])
    bench["end_to_end"] += SATURATED["end_to_end"]
    bench["per_layer"] += SATURATED["per_layer"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = rehearse("flat1m.chat-saturated", 23, fault, tmp_path / "BENCHMARK.json")
    assert r["correct"] == (fault is None), r["checks"]
    assert r["attempted"] > 0 and set(r["metrics"]) == {"setup_s", "answered_per_s"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark_torch/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark_torch", tmp_path / "benchmark_torch",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "benchmark_torch/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0", "--tiny"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_every_name_has_its_file():
    from benchmark_torch.harness import chat

    for w in BENCH["workloads"]:
        assert (ROOT / "benchmark_torch" / "traffic" / f"{w['traffic']}.json").exists()
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "benchmark_torch" / "configs" / f"{config['reference']}.py").exists()
    empty = SimpleNamespace(trace=None, trace_t0=None, trace_t1=None, latencies_ms=[], answered=0, window_s=1.0,
                            answered_span_s=None,
                            placement_seconds={}, status={"before": {}, "after": {}}, setup_s=1.0,
                            probe=SimpleNamespace(ivf_searches=[], queries=[], reranks=[]),
                            config=json.loads((ROOT / BENCH["configs"][0]["file"]).read_text()))
    from benchmark_torch.harness import arith

    empty.arith = arith
    for m in BENCH["per_layer"]:
        assert chat.load_metric(m["name"]).read(empty) is None, m["name"]
    for m in BENCH["end_to_end"]:
        assert chat.load_metric(m["name"])
