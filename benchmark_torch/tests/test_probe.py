"""The benchmark's probe (``harness/probe.py``), on the CPU:

    python -m pytest benchmark_torch/tests/test_probe.py -q

* it patches exactly the four seams every retrieval tier's query step
  passes through, and puts each back;
* over a tiny rehearsal of each cell (the flat tier's fused query step and
  the IVF tier's encode and engine search), the candidates it keeps equal,
  text for text, what hooks on ``QueryPipeline.retrieve_batch`` and
  ``MultiIndexEngine.retrieve_batch`` keep of their results.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

sys.path.insert(0, str(ROOT))


def test_probe_patches_exactly_four_seams():
    from tensortruth_tpu_torch.models.reranker import Reranker
    from tensortruth_tpu_torch.retrieval import engine
    from tensortruth_tpu_torch.services.rag_service import RAGService

    from benchmark_torch.harness.probe import Probe

    seams = {(RAGService, "_run_retrieval_batch"), (engine.MultiIndexEngine, "_postprocess"),
             (engine, "ivf_search"), (Reranker, "score_pairs_async")}
    before = {(owner, attr): getattr(owner, attr) for owner, attr in seams}
    probe = Probe().install()
    try:
        assert {(owner, attr) for owner, attr, _ in probe._undo} == seams
        assert all(getattr(owner, attr) is not before[(owner, attr)] for owner, attr in seams)
    finally:
        probe.uninstall()
    assert all(getattr(owner, attr) is before[(owner, attr)] for owner, attr in seams)


# Hooks on the two query steps' own entries, keeping what the probe kept
# before it hooked the seams they share: each query's (node id, dot) as the
# step returns them, the engine's only inside a dispatch whose texts match.
OLD_HOOKS = """
import threading
from tensortruth_tpu_torch import pipeline
from tensortruth_tpu_torch.retrieval import engine
from tensortruth_tpu_torch.services.rag_service import RAGService

old, tls, fired = {}, threading.local(), {"pipeline": 0, "engine": 0}

def keep(texts, results):
    for text, nodes in zip(texts, results):
        old[text] = [(r.node.node_id, float(r.score)) for r in nodes]

def wrap(owner, attr, make):
    setattr(owner, attr, make(getattr(owner, attr)))

def dispatch(orig):
    def run(self, texts, engine=None):
        tls.texts = list(texts)
        try:
            return orig(self, texts, engine)
        finally:
            tls.texts = None
    return run

def pipeline_step(orig):
    def retrieve_batch(self, texts):
        out = orig(self, texts)
        fired["pipeline"] += 1
        keep(texts, out)
        return out
    return retrieve_batch

def engine_step(orig):
    def retrieve_batch(self, query_embs):
        out = orig(self, query_embs)
        texts = getattr(tls, "texts", None)
        if texts is not None and len(texts) == len(out):
            fired["engine"] += 1
            keep(texts, out)
        return out
    return retrieve_batch

wrap(RAGService, "_run_retrieval_batch", dispatch)
wrap(pipeline.QueryPipeline, "retrieve_batch", pipeline_step)
wrap(engine.MultiIndexEngine, "retrieve_batch", engine_step)
"""


@pytest.mark.parametrize("cell", CELLS)
def test_candidates_equal_the_query_steps_results(cell):
    code = (
        "import json, sys, time; sys.path.insert(0, %r)\n" % str(ROOT) + OLD_HOOKS +
        "from benchmark_torch.harness import chat\n"
        "from benchmark_torch.harness.common import load_cell\n"
        "from benchmark_torch.harness.probe import Probe\n"
        "probes = []\n"
        "class Kept(Probe):\n"
        "    def install(self):\n"
        "        probes.append(self)\n"
        "        return super().install()\n"
        "chat.Probe = Kept\n"
        "r = chat.run(load_cell(%r), 41, 4.0, False, time.time(), tiny=True)\n"
        "print(json.dumps({'correct': r['correct'], 'fired': fired, 'equal': probes[0].candidates == old,\n"
        "                  'n': len(old), 'n_probe': len(probes[0].candidates)}))\n" % cell
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["n"] > 100, r
    assert r["equal"], r
    ivf = "ivf" in cell
    assert (r["fired"]["engine"] > 0) == ivf and (r["fired"]["pipeline"] > 0) != ivf, r
