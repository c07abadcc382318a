"""RAGService: engine lifecycle + the streaming query pipeline.

Port of ``tensortruth_tpu/services/rag_service.py`` onto the port's engine,
ranking and metrics (the reference module imports the JAX engine). One
deliberate difference: a failed rerank raises. The reference catches any
exception around the rerank and falls back to the dense order, which would
hide a failed kernel.

Behavioral mirror of reference services/rag_service.py:

* engine load/reload keyed by a config hash of modules+params+paths
  (reference :110-137);
* streaming ``query()`` generator: condense → retrieve → rerank →
  confidence-gated prompt selection → LLM token/thinking streaming
  (reference :214-516);
* non-LLM ``retrieve()`` for the agent's rag_query tool (reference
  :518-661) returning sources + metrics + confidence;
* LLM-only mode when no modules are attached (reference :368-429).

Device work is the fused embed -> top-k step (pipeline.py) plus bucketed
rerank batches; everything else is host-side policy.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Generator

from tensortruth_tpu_torch.core.prompts import (
    CONTEXT_PROMPT_LOW_CONFIDENCE,
    CONTEXT_PROMPT_NO_SOURCES,
    CONTEXT_PROMPT_TEMPLATE,
    LLM_ONLY_SYSTEM_PROMPT,
    NO_CONTEXT_FALLBACK_CONTEXT,
)
from tensortruth_tpu_torch.core.source import SourceNode
from tensortruth_tpu_torch.services.chat_history import ChatHistoryService
from tensortruth_tpu_torch.services.condenser import condense_query
from tensortruth_tpu_torch.engine import RAGEngine, load_engine_for_modules
from tensortruth_tpu_torch.retrieval.metrics import compute_retrieval_metrics
from tensortruth_tpu_torch.retrieval.ranking import (
    ConfidenceLevel,
    RankingStage,
    apply_confidence_gate,
)
from tensortruth_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

# Sentinel for "use the service's current engine pointer" — distinct from
# None, which means "no engine" (LLM-only).
_CURRENT = object()


@dataclass
class RAGChunk:
    """One streamed event (reference rag_service.py RAGChunk contract)."""

    text: str = ""
    thinking: str = ""
    status: str = ""  # "retrieving" | "reranking" | "generating"


@dataclass
class RAGResponse:
    text: str = ""
    sources: list[SourceNode] = field(default_factory=list)
    metrics: dict | None = None
    confidence: str = ConfidenceLevel.NORMAL.value


@dataclass
class RetrievalResult:
    """Non-LLM retrieval for the agent tool (reference rag_service.py:518-661)."""

    sources: list[SourceNode] = field(default_factory=list)
    metrics: dict | None = None
    confidence: str = ConfidenceLevel.NORMAL.value
    condensed_query: str = ""


def _params_hash(modules: list[str], params: dict, paths: list[str]) -> str:
    """Engine identity hash. Extra index paths contribute their rows.json
    mtime so a session/project document add/remove forces a reload — the
    analog of the reference's Chroma singleton-cache eviction
    (reference document_index.py:102-133)."""
    import os

    path_state = []
    for p in sorted(paths):
        rows = os.path.join(p, "rows.json")
        try:
            mtime = os.stat(rows).st_mtime_ns
        except OSError:
            mtime = 0
        path_state.append([p, mtime])
    blob = json.dumps(
        [sorted(modules), params, path_state], sort_keys=True, default=str
    )
    return hashlib.sha256(blob.encode()).hexdigest()


class RAGService:
    def __init__(self, config=None, llm_factory=None, device="cuda"):
        from tensortruth_tpu_torch.app.config import load_config

        self.config = config or load_config()
        # Where load_engine puts an engine unless its caller names a device.
        self.device = device
        self.chat_history_service = ChatHistoryService(self.config)
        self._engine: RAGEngine | None = None
        self._engine_hash: str | None = None
        # Engines cached by config hash: concurrent sessions with different
        # module sets swap the *current* pointer instead of thrashing full
        # rebuilds (analog of the reference's engine-reload-by-hash,
        # reference rag_service.py:110-137, plus Chroma's client cache).
        self._engines: OrderedDict[str, RAGEngine] = OrderedDict()
        self._max_cached_engines = 2
        # load/unload/current-pointer guard: routes run in executor threads
        # and must not null the engine out from under an in-flight query.
        self._lock = threading.RLock()
        # single-flight builds: N sessions cold-starting the SAME engine
        # must produce one build, not N (a 1M-row index load is GBs of host
        # work; duplicates stall the box). Different hashes still build in
        # parallel — only same-hash callers queue on their shared lock.
        self._build_locks: dict[str, threading.Lock] = {}
        self.last_timings: dict = {}  # stage timings of the latest query
        self._batcher = None  # services/batcher.py micro-batching (optional)
        # Worker-pool host feeding for the rerank tokenize stage
        # (services/feeder.py). Built lazily; worker
        # count from rag.host_feed_workers (0 = keep single-threaded).
        self._feeder = None
        # injectable for tests; default = provider-backed factory
        self._llm_factory = llm_factory

    # -- engine lifecycle (reference rag_service.py:110-137) -----------------

    def needs_reload(
        self, modules: list[str], params: dict, extra_index_paths: list[str] | None = None
    ) -> bool:
        with self._lock:
            return self._engine_hash != _params_hash(
                modules, params, [str(p) for p in (extra_index_paths or [])]
            )

    def _model_key(self, engine: RAGEngine) -> tuple:
        """(embedding model, reranker model or None) an engine holds resident.

        ``None`` reranker = the engine pins no reranker at all
        (use_reranker=False / params carry an explicit None)."""
        p = engine.params or {}
        emb = p.get("embedding_model") or self.config.rag.default_embedding_model
        if engine.reranker is None:
            return (emb, None)
        return (emb, p.get("reranker_model") or self.config.rag.default_reranker)

    @staticmethod
    def _models_compatible(k1: tuple, k2: tuple) -> bool:
        """Same resident-model footprint? A None reranker pins no extra device memory
        and is compatible with any reranker choice — evicting on it would
        reintroduce the full-rebuild thrash the cache exists to avoid."""
        return k1[0] == k2[0] and (
            k1[1] is None or k2[1] is None or k1[1] == k2[1]
        )

    def load_engine(
        self,
        modules: list[str],
        params: dict | None = None,
        extra_index_paths: list[str] | None = None,
        **kw,
    ) -> RAGEngine:
        params = params or {}
        h = _params_hash(
            modules, params, [str(p) for p in (extra_index_paths or [])]
        )
        with self._lock:
            cached = self._engines.get(h)
            if cached is not None:
                self._engines.move_to_end(h)
                self._engine, self._engine_hash = cached, h
                return cached
            build_lock = self._build_locks.setdefault(h, threading.Lock())
        # Build OUTSIDE self._lock: a cold build (index load + model
        # init) takes seconds-to-minutes and must not head-of-line-block
        # concurrent queries that only need the already-current engine.
        # The per-hash build_lock single-flights same-engine cold starts:
        # whoever loses the race re-checks the cache and returns the
        # winner's engine instead of re-loading GBs of index.
        with build_lock:
            with self._lock:
                existing = self._engines.get(h)
                if existing is not None:
                    self._engines.move_to_end(h)
                    self._engine, self._engine_hash = existing, h
                    return existing
            engine = load_engine_for_modules(
                modules, params, extra_index_paths=extra_index_paths,
                config=self.config, **{"device": self.device, **kw},
            )
            # Publish BEFORE releasing build_lock: a waiter blocked on the
            # build lock wakes the instant it is released, and if the cache
            # insert lived in a separate critical section the waiter's
            # re-check could land in between — re-running the GB-scale load
            # the single-flight exists to prevent.
            with self._lock:
                self._build_locks.pop(h, None)
                # A model swap means ModelManager just released the OLD
                # models' device memory — cached engines still pinning those params
                # would keep both models + both corpora resident (OOM near
                # the capacity tier). Drop every cached engine built on
                # different models.
                new_key = self._model_key(engine)
                for k in [
                    k for k, e in self._engines.items()
                    if not self._models_compatible(self._model_key(e), new_key)
                ]:
                    self._engines.pop(k).retriever.clear_cache()
                self._engines[h] = engine
                while len(self._engines) > self._max_cached_engines:
                    _, evicted = self._engines.popitem(last=False)
                    if evicted is not self._engine:
                        evicted.retriever.clear_cache()
                self._engine, self._engine_hash = engine, h
                return engine

    def unload(self) -> None:
        """Detach the current engine. Cached engines stay resident (another
        session may still point at them); ``clear_engines`` drops everything."""
        with self._lock:
            self._engine = None
            self._engine_hash = None

    def clear_engines(self) -> None:
        with self._lock:
            for engine in self._engines.values():
                engine.retriever.clear_cache()
            self._engines.clear()
            self._engine = None
            self._engine_hash = None

    @property
    def engine(self) -> RAGEngine | None:
        return self._engine

    def _get_llm(self, params: dict):
        if self._llm_factory is not None:
            return self._llm_factory(params)
        from tensortruth_tpu_torch.core.providers import create_llm

        return create_llm(params)

    # -- server-side micro-batching (SURVEY §7 step 6) -------------------------

    def enable_batching(self, max_batch: int = 32, max_wait_ms: float = 8.0) -> None:
        """Coalesce concurrent retrievals into batched device dispatches."""
        from tensortruth_tpu_torch.services.batcher import QueryBatcher

        self._batcher = QueryBatcher(
            self._run_retrieval_batch, max_batch=max_batch, max_wait_ms=max_wait_ms
        )
        self._batcher.start()

    def disable_batching(self) -> None:
        if self._batcher is not None:
            self._batcher.stop()
            self._batcher = None

    def _run_retrieval_batch(
        self, texts: list[str], engine: RAGEngine | None = None
    ):
        """Device work for N queries at once: one embed→top-k dispatch + one
        cross-query rerank pass.

        Returns a ``finish() -> list[list[SourceNode]]`` two-phase finisher
        when the reranker supports async scoring (batcher double-buffers it:
        this batch's score conversion overlaps the next batch's compute),
        else the results directly.

        ``engine`` is pinned by the enqueuing request (batcher groups by it),
        so a concurrent reload/unload cannot swap engines mid-batch."""
        engine = engine if engine is not None else self._engine
        if engine is None:
            raise RuntimeError("no engine loaded for batched retrieval")
        if engine.pipeline is not None and engine.pipeline.applicable():
            retrieved_all = engine.pipeline.retrieve_batch(texts)
        else:
            with profiling.span("query_step", queries=len(texts)):  # the encode counts its tokens
                q_embs = engine.embedder.encode(list(texts), is_query=True)
                retrieved_all = engine.retriever.retrieve_batch(q_embs)
        sources_all = [
            [SourceNode.from_retrieved(r) for r in retrieved]
            for retrieved in retrieved_all
        ]
        top_n = engine.params.get("reranker_top_n", 5)
        reranker = engine.reranker
        if reranker is None or not hasattr(reranker, "score_pairs"):
            return [srcs[:top_n] for srcs in sources_all]

        pairs, owners = [], []
        for qi, (text, sources) in enumerate(zip(texts, sources_all)):
            for s in sources:
                pairs.append((text, s.get_display_text()))
                owners.append((qi, s))

        def apply_scores(scores) -> list[list[SourceNode]]:
            for (qi, s), score in zip(owners, scores):
                s.score = float(score)
            return [
                sorted(srcs, key=lambda s: -(s.score or 0.0))[:top_n]
                for srcs in sources_all
            ]

        if pairs and hasattr(reranker, "score_pairs_async"):
            finish_scores = reranker.score_pairs_async(pairs, feeder=self._get_feeder())
            return lambda: apply_scores(finish_scores())
        return apply_scores(reranker.score_pairs(pairs) if pairs else [])

    def _get_feeder(self):
        """Lazy worker-pool host feeder (services/feeder.py). Worker count:
        ``rag.host_feed_workers`` config (0 disables), default = cpu count
        — on a multi-core serving host the rerank tokenize stage shards
        across cores instead of serializing on one."""
        if self._feeder is None:
            from tensortruth_tpu_torch.services.feeder import HostFeeder, default_workers

            n = getattr(self.config.rag, "host_feed_workers", None)
            n = default_workers() if n in (None, -1) else int(n)
            if n <= 1:
                return None
            self._feeder = HostFeeder(n)
        return self._feeder

    # -- retrieval core shared by query() and retrieve() ----------------------

    def _retrieve_and_rank(
        self, prompt: str, history_str: str, params: dict,
        engine: RAGEngine | None = None,
    ) -> RetrievalResult:
        from tensortruth_tpu_torch.utils.profiling import StageTimer

        # On the pump thread: condense, then (batched) blocked on the batcher.
        with profiling.span("rag.retrieve"):
            engine = engine if engine is not None else self._engine
            assert engine is not None
            timer = StageTimer()

            condensed = prompt
            if history_str.strip():
                with timer.stage("condense"):
                    try:
                        condensed = condense_query(
                            self._get_llm({**params, "temperature": 0.1}),
                            history_str,
                            prompt,
                        )
                    except Exception as e:
                        logger.warning("condenser unavailable (%s)", e)

            top_n = engine.params.get("reranker_top_n", 5)
            if self._batcher is not None:
                # Micro-batched path: embed→top-k→rerank coalesced with every
                # other in-flight query (services/batcher.py).
                with timer.stage("batched_retrieve_rerank"):
                    sources = self._batcher.retrieve(condensed, key=engine)
            else:
                if engine.pipeline is not None and engine.pipeline.applicable():
                    # Fused single-dispatch embed→top-k (pipeline.py).
                    with timer.stage("embed_topk_fused"):
                        retrieved = engine.pipeline.retrieve_one(condensed)
                else:
                    with timer.stage("embed"):
                        q_emb = engine.embedder.encode([condensed], is_query=True)[0]
                    with timer.stage("topk_merge"):
                        retrieved = engine.retriever.retrieve(q_emb, condensed)
                sources = [SourceNode.from_retrieved(r) for r in retrieved]

                with timer.stage("rerank"):
                    if engine.reranker is not None and sources:
                        # No fallback to the dense order: a rerank failure raises.
                        stage = RankingStage(reranker=engine.reranker)
                        sources = stage.rank(sources, condensed, top_n=top_n).passed[:top_n]
                    else:
                        sources = sources[:top_n]

            kept, level = apply_confidence_gate(
                sources,
                cutoff=engine.params.get("confidence_cutoff", 0.35),
                cutoff_hard=engine.params.get("confidence_cutoff_hard", 0.05),
            )
            metrics = compute_retrieval_metrics(kept)
            metrics.configured_top_n = top_n
            self.last_timings = timer.to_dict()
            return RetrievalResult(
                sources=kept,
                metrics={**metrics.to_dict(), "timings": self.last_timings},
                confidence=level.value,
                condensed_query=condensed,
            )

    # -- agent-tool retrieval --------------------------------------------------

    def retrieve(
        self,
        prompt: str,
        params: dict | None = None,
        session_messages: list[dict] | None = None,
        engine: "RAGEngine | None" = _CURRENT,
    ) -> RetrievalResult:
        """``engine`` pins the request to the engine its route loaded —
        without it, a concurrent session loading a different module set
        swaps the shared current pointer between load and query and this
        request would answer from the WRONG corpus. Default = the current
        pointer (single-session / test convenience)."""
        if engine is _CURRENT:
            with self._lock:
                engine = self._engine  # capture once; survives concurrent unload
        if engine is None:
            return RetrievalResult(confidence=ConfidenceLevel.NO_SOURCES.value)
        params = {**engine.params, **(params or {})}
        history = self.chat_history_service.build_history(
            session_messages, max_turns=params.get("max_history_turns")
        )
        return self._retrieve_and_rank(
            prompt, history.to_prompt_string(), params, engine=engine
        )

    # -- streaming query (reference rag_service.py:214-516) --------------------

    def query(
        self,
        prompt: str,
        params: dict | None = None,
        session_messages: list[dict] | None = None,
        engine: "RAGEngine | None" = _CURRENT,
        images: list[str] | None = None,
        system_prompt: str | None = None,
    ) -> Generator[RAGChunk, None, RAGResponse]:
        """``images``: base64-encoded images attached to THIS user turn;
        they ride the final user message to the provider as multimodal
        blocks (reference rag_service.py:431-443 — Ollama ``images`` param,
        OpenAI-compatible ``image_url`` content parts).

        ``system_prompt``: project-level system prompt composed by the chat
        context (reference chat.py:119-215) — becomes the provider system
        message on the RAG path, and prefixes the LLM-only system prompt."""
        if engine is _CURRENT:
            with self._lock:
                engine = self._engine  # capture once; survives concurrent unload
        params = {**(engine.params if engine else {}), **(params or {})}
        llm = self._get_llm(params)
        history = self.chat_history_service.build_history(
            session_messages, max_turns=params.get("max_history_turns")
        )
        history_str = history.to_prompt_string()

        response = RAGResponse()
        if engine is not None and engine.modules:
            yield RAGChunk(status="retrieving")
            result = self._retrieve_and_rank(prompt, history_str, params, engine=engine)
            yield RAGChunk(status="reranking")
            response.sources = result.sources
            response.metrics = result.metrics
            response.confidence = result.confidence

            context_str = "\n\n".join(
                f"[{i+1}] {s.get_display_text()}" for i, s in enumerate(result.sources)
            )
            if result.confidence == ConfidenceLevel.NO_SOURCES.value:
                template = CONTEXT_PROMPT_NO_SOURCES
                full_prompt = template.format(
                    chat_history=history_str, query_str=prompt
                )
            else:
                template = (
                    CONTEXT_PROMPT_LOW_CONFIDENCE
                    if result.confidence == ConfidenceLevel.LOW.value
                    else CONTEXT_PROMPT_TEMPLATE
                )
                full_prompt = template.format(
                    context_str=context_str or NO_CONTEXT_FALLBACK_CONTEXT,
                    chat_history=history_str,
                    query_str=prompt,
                )
            messages = [{"role": "user", "content": full_prompt}]
            system = system_prompt or None
        else:
            # LLM-only mode (reference rag_service.py:368-429)
            messages = history.to_chat_messages() + [
                {"role": "user", "content": prompt}
            ]
            system = (
                f"{system_prompt}\n\n{LLM_ONLY_SYSTEM_PROMPT}"
                if system_prompt
                else LLM_ONLY_SYSTEM_PROMPT
            )

        if images:
            # Vision-model chats: attach this turn's images to the user
            # message. Providers translate: Ollama passes message.images
            # natively, OpenAI-compatible expands to image_url parts.
            messages[-1] = {**messages[-1], "images": list(images)}

        yield RAGChunk(status="generating")
        parts: list[str] = []
        try:
            with profiling.span("llm.stream") as span:
                for delta in llm.stream_chat(messages, system=system):
                    span.count(chunks=1)
                    if delta.thinking:
                        yield RAGChunk(thinking=delta.thinking)
                    if delta.text:
                        parts.append(delta.text)
                        yield RAGChunk(text=delta.text)
        except Exception as e:
            err = f"\n\n[LLM error: {e}]"
            parts.append(err)
            yield RAGChunk(text=err)
        response.text = "".join(parts)
        return response
