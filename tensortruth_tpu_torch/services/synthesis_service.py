"""Phase-2 synthesis: final cited answer from gathered tool results.

Mirrors reference services/synthesis_service.py:50-371: a dedicated LLM
call with a citation-rule system prompt (numbered ``[N]`` references, no
invented sources), streaming thinking+tokens.
"""

from __future__ import annotations

import logging
from typing import Iterator

from tensortruth_tpu_torch.core.prompts import current_date_context
from tensortruth_tpu_torch.core.providers import ChatDelta

logger = logging.getLogger(__name__)

SYNTHESIS_SYSTEM_PROMPT = (
    "You are the answer-synthesis stage of a research assistant. You receive "
    "the user's question and the full outputs of the research tools that "
    "ran for it.\n\n"
    "{date_context}\n\n"
    "Citation rules:\n"
    "1. Cite evidence with bracketed numbers [1], [2] matching the source "
    "list you were given. Never invent sources or numbers.\n"
    "2. Every factual claim that came from a tool result needs a citation.\n"
    "3. If the gathered material does not answer the question, say exactly "
    "what is missing.\n"
    "4. Use Markdown structure. Include at most 3 images.\n"
)


def build_source_reference(sources: list) -> str:
    """Numbered citation list for the synthesis prompt
    (reference orchestrator_service.py:1212-1271): sequential numbering
    across knowledge-base and web sources, each annotated with its kind and
    rerank score so the LLM can weigh evidence."""

    def field(s, name, default=""):
        v = getattr(s, name, None)
        if v is None and isinstance(s, dict):
            v = s.get(name)
        return v if v is not None else default

    lines = []
    for i, s in enumerate(sources, 1):
        title = field(s, "title") or field(s, "id") or "Untitled"
        url = field(s, "url")
        stype = field(s, "type")
        stype = getattr(stype, "value", stype) or ""
        kind = "web" if stype == "web" else "knowledge base"
        score = field(s, "score", None)
        score_str = f", score: {score:.2f}" if isinstance(score, (int, float)) else ""
        suffix = f" - {url}" if url else ""
        lines.append(f'[{i}] "{title}" ({kind}{score_str}){suffix}')
    if not lines:
        return ""
    return (
        "--- Source Reference ---\n" + "\n".join(lines) + "\n--- End Source Reference ---"
    )


CHARS_PER_TOKEN = 4
INPUT_BUDGET_PCT = 0.5  # half the window for evidence, half for the answer


class SynthesisService:
    def __init__(self, llm, context_window: int = 8192):
        self.llm = llm
        self.context_window = context_window

    def synthesize(
        self,
        question: str,
        tool_outputs: list[dict],
        sources: list | None = None,
        agent_answer: str = "",
    ) -> Iterator[ChatDelta]:
        # Char-budget the evidence so the response keeps its share of the
        # window (reference orchestrator budget split :59-65).
        budget = int(self.context_window * INPUT_BUDGET_PCT) * CHARS_PER_TOKEN
        per_tool = max(500, budget // max(1, len(tool_outputs)))
        blocks = []
        for out in tool_outputs:
            text = out["output"]
            if len(text) > per_tool:
                text = text[:per_tool] + "\n[...truncated]"
            blocks.append(
                f"### Tool `{out['tool']}`\nArguments: {out['arguments']}\n\n{text}"
            )
        source_ref = build_source_reference(sources or [])
        prompt_parts = [f"Question: {question}"]
        if source_ref:
            prompt_parts.append(source_ref)
        if blocks:
            prompt_parts.append("Tool outputs:\n\n" + "\n\n".join(blocks))
        if agent_answer:
            prompt_parts.append(f"Draft answer from the research loop:\n{agent_answer}")
        prompt_parts.append("Write the final answer now.")
        system = SYNTHESIS_SYSTEM_PROMPT.format(date_context=current_date_context())
        yield from self.llm.stream_chat(
            [{"role": "user", "content": "\n\n".join(prompt_parts)}], system=system
        )
