"""The /web research pipeline: search → rerank → fetch → fit → synthesize.

Mirrors the reference flow (reference utils/web_search.py:1229-1440
``web_search_stream`` + core/source_pipeline.py:34-485):

1. DDG search (backoff) → SourceNodes;
2. title+snippet rerank on the TPU cross-encoder, threshold filter
   (reference web_search.py:118-283, threshold 0.1);
3. adaptive fetch in batches of needed+2 with per-URL status taxonomy
   (reference source_pipeline.py:159-318);
4. content rerank with thin-content penalty (<500 chars → 0.5-1.0×,
   reference web_search.py:176-251);
5. greedy context fitting: 60% input budget, 15% per-source cap
   (reference web_search.py:286-346);
6. streaming synthesis with hyperlink citations (reference
   core/synthesis.py:556-658).
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator

from tensortruth_tpu_torch.core.source import SourceNode, SourceStatus, SourceType

logger = logging.getLogger(__name__)

CHARS_PER_TOKEN = 4  # reference-wide heuristic
THIN_CONTENT_CHARS = 500


def rerank_sources(
    reranker, query: str, sources: list[SourceNode], text_fn, threshold: float
) -> tuple[list[SourceNode], list[SourceNode]]:
    """Shared rerank+filter for title and content passes."""
    texts = [text_fn(s) for s in sources]
    if reranker is None or not texts:
        return sources, []
    order, scores = reranker.rerank(query, texts, len(texts))
    passed, filtered = [], []
    for i, s in enumerate(sources):
        score = float(scores[i])
        # Thin-content penalty (reference web_search.py:176-251).
        n = len(s.content or "")
        if s.content and n < THIN_CONTENT_CHARS:
            score *= 0.5 + 0.5 * (n / THIN_CONTENT_CHARS)
        s.score = score
        (passed if score >= threshold else filtered).append(s)
    for s in filtered:
        s.status = SourceStatus.FILTERED
    passed.sort(key=lambda s: -(s.score or 0))
    return passed, filtered


def fit_sources_to_context(
    sources: list[SourceNode],
    context_window: int,
    input_pct: float = 0.6,
    per_source_pct: float = 0.15,
) -> list[SourceNode]:
    """Greedy fill-from-top (reference web_search.py:286-346)."""
    budget = int(context_window * input_pct) * CHARS_PER_TOKEN
    per_source_cap = int(context_window * per_source_pct) * CHARS_PER_TOKEN
    out: list[SourceNode] = []
    used = 0
    for s in sorted(sources, key=lambda s: -(s.score or 0)):
        content = (s.content or "")[:per_source_cap]
        if used + len(content) > budget:
            continue
        s.content = content
        out.append(s)
        used += len(content)
    skipped = len(sources) - len(out)
    if skipped:
        logger.info("context fit dropped %d sources (budget %d chars)", skipped, budget)
    return out


async def fetch_adaptive(
    sources: list[SourceNode], needed: int, emit
) -> list[SourceNode]:
    """Fetch in batches of needed+2 until enough succeed
    (reference source_pipeline.py:159-318)."""
    from tensortruth_tpu_torch.web.fetch import fetch_url_as_markdown

    fetched: list[SourceNode] = []
    queue = list(sources)
    while queue and len(fetched) < needed:
        batch, queue = queue[: needed + 2], queue[needed + 2 :]

        async def one(s: SourceNode):
            try:
                title, md = await asyncio.to_thread(fetch_url_as_markdown, s.url)
                if len(md.strip()) < 50:
                    s.status, s.error = SourceStatus.FAILED, "too_short"
                else:
                    s.content = md
                    if title:
                        s.title = title
            except asyncio.TimeoutError:
                s.status, s.error = SourceStatus.FAILED, "timeout"
            except Exception as e:
                s.status, s.error = SourceStatus.FAILED, f"http_error: {e}"
            return s

        results = await asyncio.gather(*(one(s) for s in batch))
        for s in results:
            await emit(
                {
                    "type": "tool_progress",
                    "tool": "web_search",
                    "message": f"fetched {s.url}" if s.status == SourceStatus.SUCCESS else f"failed {s.url}",
                }
            )
            if s.status == SourceStatus.SUCCESS and s.content:
                fetched.append(s)
        # progress counter on the phase line (reference AgentProgress.tsx
        # "fetching (pages_fetched/pages_target)")
        await emit(
            {
                "type": "status",
                "status": "fetching",
                "message": f"Fetching pages ({min(len(fetched), needed)}/{needed})",
            }
        )
    return fetched


async def _stream_no_sources_explanation(
    llm, query, rejected_titles, rejected_content, t_thresh, c_thresh
):
    """LLM explanation of why nothing passed (reference web_search.py:349-439)."""
    from tensortruth_tpu_torch.web.synthesis import (
        build_no_sources_prompt,
        no_sources_fallback_text,
    )

    if llm is None:
        yield {"type": "token", "content": no_sources_fallback_text(query)}
        return
    prompt = build_no_sources_prompt(
        query, rejected_titles, rejected_content, t_thresh, c_thresh
    )
    loop = asyncio.get_running_loop()
    try:
        deltas = await loop.run_in_executor(
            None, lambda: list(llm.stream_chat([{"role": "user", "content": prompt}]))
        )
        for d in deltas:
            if d.text:
                yield {"type": "token", "content": d.text}
    except Exception as e:
        logger.warning("no-sources explanation LLM failed: %s", e)
        yield {"type": "token", "content": no_sources_fallback_text(query)}


async def web_search_stream(
    query: str, context: dict
) -> AsyncIterator[dict]:
    """Full /web command flow; yields WS message dicts."""
    config = context.get("config")
    ws_cfg = config.web_search if config else None
    max_results = ws_cfg.ddg_max_results if ws_cfg else 10
    max_pages = ws_cfg.max_pages_to_fetch if ws_cfg else 5
    title_threshold = ws_cfg.rerank_title_threshold if ws_cfg else 0.1
    content_threshold = ws_cfg.rerank_content_threshold if ws_cfg else 0.1

    yield {"type": "status", "status": "searching", "message": f"Searching: {query}"}
    from tensortruth_tpu_torch.web.search import search_multi

    try:
        results = await asyncio.to_thread(search_multi, [query], max_results)
    except Exception as e:
        yield {"type": "error", "error": f"web search failed: {e}"}
        return
    sources = [
        SourceNode(title=r.title, url=r.url, snippet=r.snippet, type=SourceType.WEB)
        for r in results
    ]
    if not sources:
        yield {"type": "error", "error": "no search results"}
        return

    llm = context.get("llm")
    reranker = context.get("reranker")
    rejected_titles: list[tuple[str, float]] = []
    rejected_content: list[tuple[str, float]] = []
    if reranker is not None and (ws_cfg is None or ws_cfg.enable_title_reranking):
        yield {"type": "status", "status": "reranking", "message": "Ranking results"}
        sources, filtered = rerank_sources(
            reranker, query, sources,
            lambda s: f"{s.title}. {s.snippet}", title_threshold,
        )
        rejected_titles = [(s.title or s.url, s.score or 0.0) for s in filtered]
    if not sources:
        async for msg in _stream_no_sources_explanation(
            llm, query, rejected_titles, rejected_content,
            title_threshold, content_threshold,
        ):
            yield msg
        yield {"type": "done", "content": ""}
        return

    yield {"type": "status", "status": "fetching", "message": "Fetching pages"}
    progress_q: asyncio.Queue = asyncio.Queue()
    fetch_task = asyncio.create_task(
        fetch_adaptive(sources, max_pages, progress_q.put)
    )
    while not (fetch_task.done() and progress_q.empty()):
        try:
            yield await asyncio.wait_for(progress_q.get(), 0.2)
        except asyncio.TimeoutError:
            continue
    fetched = await fetch_task
    if not fetched:
        yield {"type": "error", "error": "no pages could be fetched"}
        return

    if reranker is not None and (ws_cfg is None or ws_cfg.enable_content_reranking):
        fetched, filtered = rerank_sources(
            reranker, query, fetched, lambda s: (s.content or "")[:2000], content_threshold
        )
        rejected_content = [(s.title or s.url, s.score or 0.0) for s in filtered]

    params = context.get("params", {})
    fitted = fit_sources_to_context(
        fetched,
        params.get("context_window", 8192),
        input_pct=ws_cfg.input_context_pct if ws_cfg else 0.6,
        per_source_pct=ws_cfg.max_source_context_pct if ws_cfg else 0.15,
    )
    if not fitted:
        async for msg in _stream_no_sources_explanation(
            llm, query, rejected_titles, rejected_content,
            title_threshold, content_threshold,
        ):
            yield msg
        yield {"type": "done", "content": ""}
        return
    yield {"type": "sources", "sources": [s.to_dict() for s in fitted]}

    if llm is None:
        yield {"type": "error", "error": "no LLM configured for synthesis"}
        return
    # Query-adaptive prompt: type detection, model-family adaptation,
    # citation style, structure template (web/synthesis.py).
    from tensortruth_tpu_torch.web.synthesis import CitationStyle, build_synthesis_prompt

    raw_style = (
        ws_cfg.citation_style
        if ws_cfg and getattr(ws_cfg, "citation_style", None)
        else "hyperlink"
    )
    try:
        style = CitationStyle(raw_style)
    except ValueError:
        # citation_style is free-form in config.yaml — a typo must not
        # break every /web query after the search work is already done
        logger.warning("unknown citation_style %r; using hyperlink", raw_style)
        style = CitationStyle.HYPERLINK
    prompt, system, temp_override = build_synthesis_prompt(
        query,
        fitted,
        model_name=params.get("model"),
        citation_style=style,
        custom_instructions=params.get("custom_instructions"),
    )
    yield {"type": "status", "status": "generating", "message": "Synthesizing"}
    loop = asyncio.get_running_loop()

    def run_stream():
        kwargs = {}
        if system is not None:
            kwargs["system"] = system
        if temp_override is not None:
            # model-family adaptation (e.g. deepseek-r1 runs best at 0.6,
            # web/synthesis.py get_model_prompt_config)
            kwargs["temperature"] = temp_override
        return list(llm.stream_chat([{"role": "user", "content": prompt}], **kwargs))

    deltas = await loop.run_in_executor(None, run_stream)
    text_parts = []
    for d in deltas:
        if d.thinking:
            yield {"type": "thinking", "content": d.thinking}
        if d.text:
            text_parts.append(d.text)
            yield {"type": "token", "content": d.text}
    yield {"type": "done", "content": "".join(text_parts)}
