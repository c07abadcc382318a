"""llama.cpp router-mode client (reference core/llama_cpp.py:1-163).

Router mode exposes ``GET /models`` (list + load status), ``POST
/models/load|unload``, and ``GET /props`` (chat template, used to probe
tool/thinking capability). Chat itself goes through the OpenAI-compatible
endpoint (core/providers.py OpenAICompatibleLLM).
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def get_available_models(base_url: str, timeout: int = 2) -> list[dict]:
    import requests

    try:
        r = requests.get(f"{base_url.rstrip('/')}/models", timeout=timeout)
        if r.status_code != 200:
            return []
        models = []
        for m in r.json().get("data", []):
            status = m.get("status", {})
            models.append(
                {
                    "id": m.get("id", ""),
                    "status": status.get("value", "unloaded") if isinstance(status, dict) else "unloaded",
                    "in_cache": m.get("in_cache", False),
                    "path": m.get("path", ""),
                }
            )
        return models
    except Exception as e:
        logger.warning("llama.cpp models query failed at %s: %s", base_url, e)
        return []


def get_loaded_models(base_url: str, timeout: int = 2) -> list[dict]:
    return [
        m for m in get_available_models(base_url, timeout)
        if m.get("status") in ("loaded", "loading")
    ]


def load_model(base_url: str, model_id: str, timeout: int = 60) -> bool:
    import requests

    try:
        r = requests.post(
            f"{base_url.rstrip('/')}/models/load",
            json={"model": model_id}, timeout=timeout,
        )
        return r.status_code == 200
    except Exception:
        return False


def unload_model(base_url: str, model_id: str, timeout: int = 30) -> bool:
    import requests

    try:
        r = requests.post(
            f"{base_url.rstrip('/')}/models/unload",
            json={"model": model_id}, timeout=timeout,
        )
        return r.status_code == 200
    except Exception:
        return False


def detect_capabilities(base_url: str, timeout: int = 5) -> list[str]:
    """Inspect /props chat template for tool/thinking markers
    (reference llama_cpp.py capability detection)."""
    import requests

    caps: list[str] = []
    try:
        r = requests.get(f"{base_url.rstrip('/')}/props", timeout=timeout)
        r.raise_for_status()
        template = str(r.json().get("chat_template", ""))
        if "tool" in template.lower():
            caps.append("tools")
        if "<think>" in template or "reasoning" in template.lower():
            caps.append("thinking")
    except Exception as e:
        logger.debug("llama.cpp props probe failed: %s", e)
    return caps


def format_display_name(model_id: str) -> str:
    """'models/Qwen2.5-7B-Q4_K_M.gguf' → 'Qwen2.5 7B Q4_K_M'."""
    name = model_id.rsplit("/", 1)[-1]
    if name.endswith(".gguf"):
        name = name[:-5]
    return name.replace("-", " ").replace("_", " ").strip() or model_id
