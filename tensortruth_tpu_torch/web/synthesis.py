"""Query-adaptive web synthesis: prompt engineering for the /web pipeline.

Behavioral mirror of the reference's synthesis engine
(reference core/synthesis.py:77-349): rule-based query-type detection,
model-family prompt adaptation (deepseek-r1 refuses system prompts),
HYPERLINK vs BRACKET citation styles with worked examples, and
query-adaptive structure templates. Plus the no-sources LLM explanation
(reference utils/web_search.py:349-439). All host-side policy — nothing
here touches the TPU.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum
from typing import Sequence


class QueryType(str, Enum):
    PERSON = "person"
    COMPARISON = "comparison"
    NEWS_EVENT = "news_event"
    TECHNICAL = "technical"
    GENERAL = "general"


class CitationStyle(str, Enum):
    HYPERLINK = "hyperlink"  # [Title](url) — default for /web
    BRACKET = "bracket"  # [Source N]


_QUERY_PATTERNS: list[tuple[QueryType, re.Pattern]] = [
    (
        QueryType.PERSON,
        re.compile(r"\b(who is|who was|biography|life of|background of)\b", re.I),
    ),
    (
        QueryType.COMPARISON,
        re.compile(r"\b(compare|versus|vs\.?|difference between|pros and cons)\b", re.I),
    ),
    (
        QueryType.NEWS_EVENT,
        re.compile(
            r"\b(news|latest|recent|what happened|timeline|developments)\b", re.I
        ),
    ),
    (
        QueryType.TECHNICAL,
        re.compile(
            r"\b(how to|implementation|algorithm|api|documentation|tutorial)\b", re.I
        ),
    ),
]


def detect_query_type(query: str) -> QueryType:
    """First matching rule wins; GENERAL otherwise (reference :91-106)."""
    for qtype, pat in _QUERY_PATTERNS:
        if pat.search(query):
            return qtype
    return QueryType.GENERAL


@dataclass
class ModelPromptConfig:
    """Per-model-family prompt quirks (reference :111-140)."""

    use_system_prompt: bool = True
    temperature_override: float | None = None
    include_reasoning_directives: bool = False
    model_family: str = "generic"


def get_model_prompt_config(model_name: str | None) -> ModelPromptConfig:
    if not model_name:
        return ModelPromptConfig()
    name = model_name.lower()
    if "deepseek-r1" in name:
        # R1 is trained without system prompts; fold everything into the
        # user turn and let its built-in reasoning run at temp 0.6.
        return ModelPromptConfig(
            use_system_prompt=False,
            temperature_override=0.6,
            include_reasoning_directives=True,
            model_family="deepseek-r1",
        )
    if "qwen3" in name:
        return ModelPromptConfig(model_family="qwen3")
    if "llama" in name:
        return ModelPromptConfig(model_family="llama")
    return ModelPromptConfig()


def build_citation_instructions(
    style: CitationStyle,
    example_title: str = "Example Page",
    example_url: str = "https://example.com/page",
    include_reasoning: bool = False,
) -> str:
    """Citation rules with worked right/wrong examples (reference :213-277)."""
    if style == CitationStyle.BRACKET:
        return (
            "Citation rules:\n"
            "- Cite as [Source N] immediately after each claim it supports.\n"
            '- Example: "The method reaches 95% accuracy [Source 1]."\n'
            "- Multiple sources: [Source 1], [Source 3].\n"
            "- Never cite a source number that does not exist."
        )
    reasoning = ""
    if include_reasoning:
        reasoning = (
            "\nBefore writing, silently check for each claim: which source "
            "supports it, and how will I cite it inline?\n"
        )
    return (
        "Citation rules — follow exactly:\n"
        "1. Every citation is a markdown hyperlink: [Title](url).\n"
        "   Never bare numbers like [1] or 'Source 3'.\n"
        "2. Correct: 'According to "
        f"[{example_title}]({example_url}), ...'\n"
        "   Correct: 'The [retrieval benchmark](https://example.org/bench) "
        "shows ...'\n"
        "3. Wrong: 'According to [2], ...' — never do this.\n"
        "4. Preserve hyperlinks that already exist in source content.\n"
        "5. Cite multiple sources together as [A](url1), [B](url2)."
        + reasoning
    )


_STRUCTURE_SECTIONS: dict[QueryType, str] = {
    QueryType.PERSON: (
        "### Background & Early Life (if relevant)\n"
        "### Career & Achievements (if relevant)\n"
        "### Impact & Legacy (if relevant)"
    ),
    QueryType.COMPARISON: (
        "### Key Similarities (if relevant)\n"
        "### Key Differences (if relevant)\n"
        "### Comparative Analysis (if relevant)\n"
        "### Recommendation (if relevant)"
    ),
    QueryType.NEWS_EVENT: (
        "### Timeline of Events (if relevant)\n"
        "### Key Developments (if relevant)\n"
        "### Impact & Analysis (if relevant)"
    ),
    QueryType.TECHNICAL: (
        "### Technical Details (if relevant)\n"
        "### Implementation Steps (if relevant)\n"
        "### Examples & Use Cases (if relevant)\n"
        "### Key Considerations (if relevant)"
    ),
    QueryType.GENERAL: (
        "### Key Concepts (if relevant)\n"
        "### Detailed Analysis (if relevant)\n"
        "### Important Takeaways (if relevant)"
    ),
}


def build_structure_template(qtype: QueryType, style: CitationStyle) -> str:
    """Enforced Overview + query-adaptive optional sections (reference :279-349)."""
    cite = "[Source N]" if style == CitationStyle.BRACKET else "[title](url)"
    return (
        "Response structure:\n\n"
        "### Overview\n"
        f"(required: brief introduction with inline citations {cite})\n\n"
        "Then organize with sections that fit the information, e.g.:\n"
        f"{_STRUCTURE_SECTIONS[qtype]}\n\n"
        "Only include sections the sources actually support."
    )


def build_synthesis_prompt(
    query: str,
    sources: Sequence,  # SourceNode-like: .title/.url/.content
    model_name: str | None = None,
    citation_style: CitationStyle = CitationStyle.HYPERLINK,
    custom_instructions: str | None = None,
) -> tuple[str, str | None, float | None]:
    """Compose the full synthesis prompt.

    Returns (user_prompt, system_prompt_or_None, temperature_override).
    System prompt is folded into the user turn for model families that
    cannot take one (deepseek-r1).
    """
    mcfg = get_model_prompt_config(model_name)
    qtype = detect_query_type(query)
    first = sources[0] if sources else None
    citation = build_citation_instructions(
        citation_style,
        example_title=(getattr(first, "title", None) or "Example Page"),
        example_url=(getattr(first, "url", None) or "https://example.com/page"),
        include_reasoning=mcfg.include_reasoning_directives,
    )
    structure = build_structure_template(qtype, citation_style)

    if citation_style == CitationStyle.BRACKET:
        blocks = [
            f"[Source {i + 1}] {s.title}\n{s.content}"
            for i, s in enumerate(sources)
        ]
    else:
        blocks = [
            f"### Source: [{s.title}]({s.url})\n{s.content}" for s in sources
        ]
    sources_block = "\n\n".join(blocks)

    system = (
        "You are a research assistant writing a well-structured, cited "
        "synthesis of web sources. Answer directly from the sources; note "
        "disagreements explicitly; say so when the sources do not answer "
        "the question."
    )
    body = (
        f"{sources_block}\n\n{citation}\n\n{structure}\n\n"
        + (f"Additional instructions: {custom_instructions}\n\n" if custom_instructions else "")
        + f"Question: {query}\n"
    )
    if not mcfg.use_system_prompt:
        return f"{system}\n\n{body}", None, mcfg.temperature_override
    return body, system, mcfg.temperature_override


def build_no_sources_prompt(
    query: str,
    rejected_titles: Sequence[tuple[str, float]],
    rejected_content: Sequence[tuple[str, float]],
    title_threshold: float,
    content_threshold: float,
) -> str:
    """Prompt for the LLM explanation when nothing passed the thresholds
    (reference utils/web_search.py:349-439)."""

    def fmt(items):
        return (
            "\n".join(f'  - "{t}" (score: {s * 100:.0f}%)' for t, s in items[:5])
            or "  (none)"
        )

    total = len(rejected_titles) + len(rejected_content)
    return (
        "You are explaining why a web search found no usable sources.\n\n"
        f'Query: "{query}"\n'
        f"Results found: {total}\n"
        f"Rejected at the title stage (below {title_threshold * 100:.0f}% relevance):\n"
        f"{fmt(rejected_titles)}\n"
        f"Rejected at the content stage (below {content_threshold * 100:.0f}% relevance):\n"
        f"{fmt(rejected_content)}\n\n"
        "Write 2-3 sentences: acknowledge the search, explain plainly that "
        "nothing was relevant enough, and suggest how to rephrase the "
        "query. Be concise; do not over-apologize."
    )


def no_sources_fallback_text(query: str) -> str:
    return (
        f'I searched for "{query}" but no sources met the relevance '
        "threshold. Try rephrasing the query or using more specific terms."
    )
