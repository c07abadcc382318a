"""FunctionAgent: the generic tool-calling loop.

Mirrors the reference's LlamaIndex ``FunctionAgent`` usage
(reference orchestrator_service.py:646-1006): bounded iterations (default
10), per-iteration LLM turn with tool schemas, async tool execution with
progress events, transient-error retry (2 attempts), full-output
side-channel — the scratchpad keeps a summary while the synthesis stage
receives full tool outputs (reference :246-248,851-898).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import AsyncIterator

from tensortruth_tpu_torch.agents.base import Agent

logger = logging.getLogger(__name__)

SCRATCHPAD_SUMMARY_CHARS = 700  # tool result excerpt kept in the loop context
TRANSIENT_MARKERS = ("timeout", "connection", "temporarily", "503", "502", "overloaded")


def is_transient_error(e: Exception) -> bool:
    """(reference orchestrator_service.py:101-116)."""
    msg = str(e).lower()
    return any(m in msg for m in TRANSIENT_MARKERS)


class FunctionAgent(Agent):
    name = "function"

    def __init__(
        self,
        context: dict | None = None,
        system_prompt: str = "",
        allowed_tools: list[str] | None = None,
        max_iterations: int = 10,
        model: str | None = None,
    ):
        self.context = context or {}
        self.system_prompt = system_prompt
        self.allowed_tools = allowed_tools
        self.max_iterations = max_iterations
        self.model = model
        # side-channel: full tool outputs for the synthesis stage
        self.full_outputs: list[dict] = []

    def _tools(self):
        tool_service = self.context.get("tool_service")
        extra = self.context.get("extra_tools", {})  # name -> ToolSpec
        tools = dict(extra)
        if tool_service is not None:
            tools.update(tool_service.tools)
        if self.allowed_tools is not None:
            tools = {n: t for n, t in tools.items() if n in self.allowed_tools}
        return tools

    async def run(self, task: str, context: dict | None = None) -> AsyncIterator[dict]:
        context = {**self.context, **(context or {})}
        llm = context.get("llm")
        if llm is None:
            yield {"type": "error", "error": "no LLM available for agent"}
            return
        tools = self._tools()
        schemas = [
            {"name": t.name, "description": t.description, "parameters": t.parameters}
            for t in tools.values()
        ]
        messages: list[dict] = list(context.get("history", []))
        user_msg: dict = {"role": "user", "content": task}
        # Attached images ride the task's user turn — both provider
        # chat_with_tools paths consume the `images` key (Ollama verbatim,
        # OpenAI-compat via _openai_multimodal).
        if context.get("images"):
            user_msg["images"] = list(context["images"])
        messages.append(user_msg)

        final_text = ""
        for iteration in range(self.max_iterations):
            text, calls = None, None
            for attempt in range(2):  # transient retry (reference :958-989)
                try:
                    text, calls = await asyncio.to_thread(
                        llm.chat_with_tools, messages, schemas, self.system_prompt or None
                    )
                    break
                except NotImplementedError:
                    yield {"type": "error", "error": "model lacks tool calling"}
                    return
                except Exception as e:
                    if attempt == 0 and is_transient_error(e):
                        logger.warning("transient LLM error, retrying: %s", e)
                        await asyncio.sleep(1)
                        continue
                    yield {"type": "error", "error": f"agent LLM failed: {e}"}
                    return
            if not calls:
                final_text = text or ""
                break

            if text and context.get("show_reasoning"):
                # Loop-internal commentary (reference orchestrator
                # `show_orchestrator_reasoning`, config_schema.py AgentConfig).
                yield {"type": "reasoning", "content": text}

            # tool_call ids keep OpenAI-compatible servers happy; Ollama
            # ignores the extra fields.
            call_ids = [f"call_{iteration}_{j}" for j in range(len(calls))]
            messages.append(
                {"role": "assistant", "content": text or "",
                 "tool_calls": [
                     {"id": cid, "type": "function",
                      # the chat-completions schema requires arguments as a
                      # JSON STRING; spec-strict servers 400 on a dict
                      "function": {"name": c["name"],
                                   "arguments": json.dumps(c["arguments"] or {})}}
                     for cid, c in zip(call_ids, calls)
                 ]}
            )
            # Parallel tool execution (reference orchestrator_service.py:504-515).
            yield {
                "type": "tool_phase",
                "tools": [c["name"] for c in calls],
                # per-call params so the client's live timeline can show
                # what each parallel call is doing (reference ToolSteps.tsx
                # paramsSummary; useWebSocket.ts tool_phase handler)
                "calls": [
                    {"tool": c["name"], "params": c.get("arguments") or {}}
                    for c in calls
                ],
                "iteration": iteration + 1,
            }

            async def run_one(call):
                name, args = call["name"], call.get("arguments") or {}
                if name not in tools:
                    return name, args, f"ERROR: unknown tool {name}"
                try:
                    result = await tools[name].fn(**args)
                except Exception as e:
                    # A tool that declares it (retrieval, which runs the
                    # device kernels) fails the agent rather than reaching
                    # the LLM as text. Other tools' failures stay results.
                    if tools[name].propagate_errors:
                        raise
                    return name, args, f"ERROR: {e}"
                return name, args, result

            results = await asyncio.gather(*(run_one(c) for c in calls))
            for cid, (name, args, result) in zip(call_ids, results):
                text_result = (
                    result if isinstance(result, str)
                    else json.dumps(result, ensure_ascii=False, default=str)
                )
                self.full_outputs.append(
                    {"tool": name, "arguments": args, "output": text_result}
                )
                yield {
                    "type": "tool_progress",
                    "tool": name,
                    "message": text_result[:200],
                    # completion status + expandable output for the live
                    # step timeline (reference ToolStepWithStatus)
                    "phase": (
                        "failed" if text_result.startswith("ERROR:")
                        else "completed"
                    ),
                    "output": text_result[:2000],
                }
                # Scratchpad gets a summary; synthesis sees full output.
                messages.append(
                    {"role": "tool", "name": name, "tool_call_id": cid,
                     "content": text_result[:SCRATCHPAD_SUMMARY_CHARS]}
                )
        else:
            # Max iterations: fall through with whatever was gathered
            # (reference :938-956).
            final_text = ""

        yield {"type": "agent_done", "content": final_text,
               "tool_outputs": self.full_outputs}
