"""Follow-up → standalone query condensation via a small LLM call.

Mirrors reference utils/history_condenser.py: dedicated low-temperature
condenser LLM, entity-preserving prompt (core/prompts.py
CONDENSE_PROMPT_TEMPLATE), and fallback to the original question on any
error — condensation must never break a query.
"""

from __future__ import annotations

import logging

from tensortruth_tpu_torch.core.prompts import CONDENSE_PROMPT_TEMPLATE

logger = logging.getLogger(__name__)


def condense_query(
    llm,
    chat_history: str,
    question: str,
    prompt_template: str = CONDENSE_PROMPT_TEMPLATE,
    fallback_on_error: bool = True,
) -> str:
    """``llm`` needs ``complete(prompt) -> str`` (core/providers.py)."""
    if not chat_history.strip():
        return question
    prompt = prompt_template.format(chat_history=chat_history, question=question)
    try:
        out = llm.complete(prompt).strip()
        return out or question
    except Exception as e:
        if fallback_on_error:
            logger.warning("condense failed (%s); using original question", e)
            return question
        raise
