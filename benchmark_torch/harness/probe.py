"""The benchmark's own spans and records around calls into the program.

``Probe.install`` wraps, for the life of the process, the calls each layer
is entered by:

* ``RAGService._run_retrieval_batch`` (one batcher dispatch): span
  ``bench.batch``;
* ``QueryPipeline.retrieve_batch`` (flat tier), or the query encode and
  ``MultiIndexEngine.retrieve_batch`` inside a dispatch (IVF tier): span
  ``bench.query_step``; each query's candidates (node id, dot) are kept for
  the comparison;
* the search the query step calls (``fused_topk`` as the pipeline calls it,
  ``ivf_search`` as the engine calls it): span ``bench.search``, with the
  shapes its roofline is counted from;
* ``Reranker.score_pairs_async`` and the finisher it returns: span
  ``bench.rerank``, with the pairs it scored.

Spans are ``torch.profiler.record_function`` ranges, entered only while a
trace runs; the records are kept in every run. A planted fault (tests
only) breaks the timed path underneath: ``score`` alters every rerank
score where it is produced (+0.02), ``half`` leaves out the second half of
every rerank batch and gives it the mean of the first half's scores,
``reverse`` hands back each query's sources in ascending order.
"""

from __future__ import annotations

import contextlib
import threading
import time


class Probe:
    def __init__(self, fault: str | None = None):
        self.tracing = False
        self.fault = fault
        self.candidates: dict[str, list] = {}  # query text -> [(node id, dot)]
        self.searches: list[dict] = []
        self.reranks: list[tuple[float, list]] = []  # (host time, pairs)
        self.queries: list[tuple[float, list]] = []  # (host time, query texts)
        self._tls = threading.local()
        self._undo: list = []

    def span(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def _patch(self, owner, attr: str, make) -> None:
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def _keep(self, texts, results) -> None:
        for text, nodes in zip(texts, results):
            self.candidates[text] = [(r.node.node_id, float(r.score)) for r in nodes]

    def install(self) -> "Probe":
        from tensortruth_tpu_torch import pipeline
        from tensortruth_tpu_torch.models.embedder import Embedder
        from tensortruth_tpu_torch.models.reranker import Reranker
        from tensortruth_tpu_torch.retrieval import engine
        from tensortruth_tpu_torch.services.rag_service import RAGService

        probe, tls = self, self._tls

        def dispatch(orig):
            def run_batch(self, texts, engine=None):
                tls.texts = list(texts)
                probe.queries.append((time.perf_counter(), tls.texts))
                try:
                    with probe.span("bench.batch"):
                        out = orig(self, texts, engine)
                finally:
                    tls.texts = None
                if probe.fault == "reverse":
                    return (lambda f: lambda: [s[::-1] for s in f()])(out) if callable(out) else [s[::-1] for s in out]
                return out
            return run_batch

        def pipeline_step(orig):
            def retrieve_batch(self, texts):
                with probe.span("bench.query_step"):
                    out = orig(self, texts)
                probe._keep(texts, out)
                return out
            return retrieve_batch

        def engine_step(orig):
            def retrieve_batch(self, query_embs):
                with probe.span("bench.query_step"):
                    out = orig(self, query_embs)
                texts = getattr(tls, "texts", None)
                if texts is not None and len(texts) == len(out):
                    probe._keep(texts, out)
                return out
            return retrieve_batch

        def encode_step(orig):
            def encode(self, texts, is_query=False, batch_size=None):
                if is_query and getattr(tls, "texts", None) is not None:
                    with probe.span("bench.query_step"):
                        return orig(self, texts, is_query, batch_size)
                return orig(self, texts, is_query, batch_size)
            return encode

        def flat_search(orig):
            def fused_topk(q, emb, k, *args, **kw):
                texts = getattr(tls, "texts", None)
                probe.searches.append({
                    "t": time.perf_counter(), "kind": "flat", "b": len(texts) if texts else q.shape[0],
                    "n": kw.get("n_actual") or emb.shape[0], "d": emb.shape[1], "k": k,
                    "elem": emb.element_size()})
                with probe.span("bench.search"):
                    return orig(q, emb, k, *args, **kw)
            return fused_topk

        def ivf(orig):
            def ivf_search(index, q, k, nprobe=8, plain=False):
                probe.searches.append({
                    "t": time.perf_counter(), "kind": "ivf", "b": q.shape[0], "k": k, "nprobe": nprobe,
                    "q": q.detach().clone() if probe.tracing else None, "index": index})
                with probe.span("bench.search"):
                    return orig(index, q, k, nprobe, plain)
            return ivf_search

        def rerank(orig):
            def score_pairs_async(self, pairs, feeder=None):
                probe.reranks.append((time.perf_counter(), pairs))
                with probe.span("bench.rerank"):
                    finish = orig(self, pairs, feeder)

                def finished():
                    with probe.span("bench.rerank"):
                        scores = finish()
                    return probe._break(scores)
                return finished
            return score_pairs_async

        self._patch(RAGService, "_run_retrieval_batch", dispatch)
        self._patch(pipeline.QueryPipeline, "retrieve_batch", pipeline_step)
        self._patch(engine.MultiIndexEngine, "retrieve_batch", engine_step)
        self._patch(Embedder, "encode", encode_step)
        self._patch(pipeline, "fused_topk", flat_search)
        self._patch(engine, "ivf_search", ivf)
        self._patch(Reranker, "score_pairs_async", rerank)
        return self

    def _break(self, scores):
        if self.fault == "score":
            scores = scores + 0.02
        elif self.fault == "half" and len(scores) > 1:
            scores = scores.copy()
            half = len(scores) // 2
            scores[half:] = scores[:half].mean()
        return scores
