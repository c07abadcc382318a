"""The benchmark's records of calls into the program, and its planted
faults.

``Probe.install`` wraps, for the life of the process, four seams that every
retrieval tier's query step passes through:

* ``RAGService._run_retrieval_batch`` (one batcher dispatch): the
  dispatch's query texts, for ``serve_mfu`` and to pair with its
  candidates;
* ``MultiIndexEngine._postprocess`` (one call a query, in query order, on
  every tier): each query's candidates (node id, dot), kept for the
  comparison once the dispatch's count of them matches its texts;
* ``ivf_search`` as the engine calls it: the query and the index that the
  IVF roofline counts the probed clusters from;
* ``Reranker.score_pairs_async``: the pairs it scored.

The layers' times are the program's own ``tt.*`` spans, read from the
trace (``harness/trace.py``); the probe opens no range. A planted fault
(tests only) breaks the timed path underneath: ``score`` alters every
rerank score where it is produced (+0.02), ``half`` leaves out the second
half of every rerank batch and gives it the mean of the first half's
scores, ``reverse`` hands back each query's sources in ascending order.
"""

from __future__ import annotations

import threading
import time


class Probe:
    def __init__(self, fault: str | None = None):
        self.tracing = False
        self.fault = fault
        self.candidates: dict[str, list] = {}  # query text -> [(node id, dot)]
        self.ivf_searches: list[tuple[float, dict]] = []  # (host time, query and index)
        self.reranks: list[tuple[float, list]] = []  # (host time, pairs)
        self.queries: list[tuple[float, list]] = []  # (host time, query texts)
        self._tls = threading.local()
        self._undo: list = []

    def _patch(self, owner, attr: str, make) -> None:
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def install(self) -> "Probe":
        from tensortruth_tpu_torch.models.reranker import Reranker
        from tensortruth_tpu_torch.retrieval import engine
        from tensortruth_tpu_torch.services.rag_service import RAGService

        probe, tls = self, self._tls

        def dispatch(orig):
            def run_batch(self, texts, engine=None):
                texts, found = list(texts), []
                probe.queries.append((time.perf_counter(), texts))
                tls.found = found
                try:
                    out = orig(self, texts, engine)
                finally:
                    tls.found = None
                if len(found) == len(texts):
                    probe.candidates.update(zip(texts, found))
                if probe.fault == "reverse":
                    return (lambda f: lambda: [s[::-1] for s in f()])(out) if callable(out) else [s[::-1] for s in out]
                return out
            return run_batch

        def postprocess(orig):
            def _postprocess(self, scores, rows):
                out = orig(self, scores, rows)
                found = getattr(tls, "found", None)
                if found is not None:
                    found.append([(r.node.node_id, float(r.score)) for r in out])
                return out
            return _postprocess

        def ivf(orig):
            def ivf_search(index, q, k, nprobe=8, plain=False):
                if probe.tracing:
                    probe.ivf_searches.append((time.perf_counter(), {
                        "q": q.detach().clone(), "index": index, "k": k, "nprobe": nprobe}))
                return orig(index, q, k, nprobe, plain)
            return ivf_search

        def rerank(orig):
            def score_pairs_async(self, pairs, feeder=None):
                probe.reranks.append((time.perf_counter(), pairs))
                finish = orig(self, pairs, feeder)
                return lambda: probe._break(finish())
            return score_pairs_async

        self._patch(RAGService, "_run_retrieval_batch", dispatch)
        self._patch(engine.MultiIndexEngine, "_postprocess", postprocess)
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
