"""LLM provider abstraction: registry, clients, factory.

Host-side re-implementation of the reference's provider layer
(reference core/providers.py:22-710, core/ollama.py, core/llama_cpp.py):
the retrieval engine is TPU-native, but generation stays on external
OpenAI-compatible / Ollama / llama.cpp HTTP servers exactly like the
reference. Contracts kept:

* ``ProviderRegistry`` over configured providers with model discovery and
  ``resolve_model`` fallback chain (reference providers.py:137-284);
* capability probes (tools / thinking) with a TTL cache (:388-486);
* ``create_llm`` dispatch per provider type (:494-679) with cached
  orchestrator LLM (temp 0.2, thinking off) and tool/synthesis LLM
  (temp 0.7, thinking auto);
* ``${ENV_VAR}`` api-key expansion at request time only.

The LLM client interface this engine depends on:
    complete(prompt) -> str
    stream_chat(messages, system=None) -> Iterator[ChatDelta]
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Iterator

from tensortruth_tpu_torch.app.config import ProviderConfig, expand_env_vars

logger = logging.getLogger(__name__)

CAPABILITY_CACHE_TTL = 300  # 5 min (reference providers.py:443-486)


@dataclass
class ChatDelta:
    """One streaming chunk: answer text and/or thinking tokens."""

    text: str = ""
    thinking: str = ""


@dataclass(frozen=True)
class ModelReference:
    """provider_id + model name (reference providers.py:22-39)."""

    provider_id: str
    model: str

    def qualified(self) -> str:
        return f"{self.provider_id}/{self.model}"


class BaseLLM:
    """Shared HTTP plumbing for provider clients."""

    def __init__(
        self,
        base_url: str,
        model: str,
        api_key: str = "",
        temperature: float = 0.7,
        context_window: int = 8192,
        max_tokens: int = 4096,
        timeout: int = 300,
        thinking: bool | None = None,
        extra_payload: dict | None = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.temperature = temperature
        self.context_window = context_window
        self.max_tokens = max_tokens
        self.timeout = timeout
        self.thinking = thinking
        # provider-specific request params merged into every chat payload
        # (llama.cpp reasoning_format/think_budget — reference
        # providers.py:564-589 additional_kwargs)
        self.extra_payload = dict(extra_payload or {})

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        key = expand_env_vars(self.api_key) if self.api_key else ""
        if key:
            h["Authorization"] = f"Bearer {key}"
        return h

    def complete(self, prompt: str) -> str:
        out = []
        for delta in self.stream_chat([{"role": "user", "content": prompt}]):
            out.append(delta.text)
        return "".join(out)

    def stream_chat(
        self,
        messages: list[dict],
        system: str | None = None,
        temperature: float | None = None,
    ) -> Iterator[ChatDelta]:
        """``temperature`` overrides the instance default for this call only
        (model-family prompt adaptation, web/synthesis.py
        ModelPromptConfig.temperature_override)."""
        raise NotImplementedError

    def chat_with_tools(
        self, messages: list[dict], tools: list[dict], system: str | None = None
    ) -> tuple[str, list[dict]]:
        """One non-streaming turn with tool schemas.

        Returns (assistant_text, tool_calls) where each tool call is
        {"name": ..., "arguments": {...}}. Providers without tool support
        raise NotImplementedError (the orchestrator then degrades to the
        direct pipeline, reference chat.py:839-847).
        """
        raise NotImplementedError


class OllamaLLM(BaseLLM):
    """Ollama /api/chat streaming client (reference core/ollama.py:24-545).

    Multimodal: a message dict may carry ``images: [base64, ...]`` — the
    exact shape Ollama's chat API consumes for vision models (reference
    rag_service.py:431-443), so messages pass through verbatim."""

    def stream_chat(self, messages, system=None, temperature=None) -> Iterator[ChatDelta]:
        import requests

        msgs = ([{"role": "system", "content": system}] if system else []) + messages
        payload = {
            "model": self.model,
            "messages": msgs,
            "stream": True,
            "options": {
                "temperature": self.temperature if temperature is None else temperature,
                "num_ctx": self.context_window,
                "num_predict": self.max_tokens,
            },
        }
        if self.thinking is not None:
            payload["think"] = self.thinking
        with requests.post(
            f"{self.base_url}/api/chat",
            json=payload,
            stream=True,
            timeout=self.timeout,
            headers=self._headers(),
        ) as r:
            r.raise_for_status()
            for line in r.iter_lines():
                if not line:
                    continue
                data = json.loads(line)
                msg = data.get("message", {})
                if msg.get("thinking"):
                    yield ChatDelta(thinking=msg["thinking"])
                if msg.get("content"):
                    yield ChatDelta(text=msg["content"])
                if data.get("done"):
                    break

    def list_models(self) -> list[str]:
        import requests

        r = requests.get(f"{self.base_url}/api/tags", timeout=10)
        r.raise_for_status()
        return [m["name"] for m in r.json().get("models", [])]

    def chat_with_tools(self, messages, tools, system=None):
        import requests

        msgs = ([{"role": "system", "content": system}] if system else []) + messages
        payload = {
            "model": self.model,
            "messages": msgs,
            "stream": False,
            "tools": [
                {"type": "function", "function": t} for t in tools
            ],
            "options": {"temperature": self.temperature, "num_ctx": self.context_window},
        }
        r = requests.post(
            f"{self.base_url}/api/chat", json=payload,
            timeout=self.timeout, headers=self._headers(),
        )
        r.raise_for_status()
        msg = r.json().get("message", {})
        calls = [
            {
                "name": tc["function"]["name"],
                "arguments": tc["function"].get("arguments", {}),
            }
            for tc in msg.get("tool_calls", [])
        ]
        return msg.get("content", ""), calls


#: base64 prefixes of the magic bytes for the image formats browsers emit;
#: clients send raw base64 with the data: prefix stripped, so the mime must
#: be recovered from the payload itself — a wrong one (e.g. jpeg for a PNG)
#: is rejected by strict OpenAI-compatible servers.
_B64_MAGIC_MIME = (
    ("/9j/", "image/jpeg"),
    ("iVBORw", "image/png"),
    ("R0lGOD", "image/gif"),
    ("UklGR", "image/webp"),
)


def _sniff_image_mime(b64: str) -> str:
    for prefix, mime in _B64_MAGIC_MIME:
        if b64.startswith(prefix):
            return mime
    return "image/jpeg"


def _openai_multimodal(messages: list[dict]) -> list[dict]:
    """Expand ``images`` keys into OpenAI content-part format: a message
    {"content": c, "images": [b64...]} becomes content parts
    [{"type": "text", ...}, {"type": "image_url", ...}] (reference
    rag_service.py:431-443 multimodal blocks). Messages without images
    pass through untouched."""
    out = []
    for m in messages:
        if not m.get("images"):
            out.append({k: v for k, v in m.items() if k != "images"})
            continue
        parts = [{"type": "text", "text": m.get("content", "")}]
        for b64 in m["images"]:
            url = (b64 if b64.startswith("data:")
                   else f"data:{_sniff_image_mime(b64)};base64,{b64}")
            parts.append({"type": "image_url", "image_url": {"url": url}})
        out.append({"role": m.get("role", "user"), "content": parts})
    return out


class OpenAICompatibleLLM(BaseLLM):
    """OpenAI-compatible /v1/chat/completions SSE client
    (reference providers.py:533-561; also serves llama.cpp router mode)."""

    def stream_chat(self, messages, system=None, temperature=None) -> Iterator[ChatDelta]:
        import requests

        messages = _openai_multimodal(messages)
        msgs = ([{"role": "system", "content": system}] if system else []) + messages
        payload = {
            "model": self.model,
            "messages": msgs,
            "stream": True,
            "temperature": self.temperature if temperature is None else temperature,
            "max_tokens": self.max_tokens,
            **self.extra_payload,
        }
        url = self.base_url
        if not url.endswith("/v1"):
            url = url + "/v1"
        with requests.post(
            f"{url}/chat/completions",
            json=payload,
            stream=True,
            timeout=self.timeout,
            headers=self._headers(),
        ) as r:
            r.raise_for_status()
            for line in r.iter_lines():
                if not line or not line.startswith(b"data:"):
                    continue
                body = line[5:].strip()
                if body == b"[DONE]":
                    break
                delta = json.loads(body)["choices"][0].get("delta", {})
                if delta.get("reasoning_content"):
                    yield ChatDelta(thinking=delta["reasoning_content"])
                if delta.get("content"):
                    yield ChatDelta(text=delta["content"])

    def list_models(self) -> list[str]:
        import requests

        url = self.base_url
        if not url.endswith("/v1"):
            url = url + "/v1"
        r = requests.get(f"{url}/models", timeout=10, headers=self._headers())
        r.raise_for_status()
        return [m["id"] for m in r.json().get("data", [])]

    def chat_with_tools(self, messages, tools, system=None):
        import requests

        messages = _openai_multimodal(messages)
        msgs = ([{"role": "system", "content": system}] if system else []) + messages
        url = self.base_url
        if not url.endswith("/v1"):
            url = url + "/v1"
        payload = {
            "model": self.model,
            "messages": msgs,
            "temperature": self.temperature,
            "max_tokens": self.max_tokens,
            "tools": [{"type": "function", "function": t} for t in tools],
            **self.extra_payload,
        }
        r = requests.post(
            f"{url}/chat/completions", json=payload,
            timeout=self.timeout, headers=self._headers(),
        )
        r.raise_for_status()
        msg = r.json()["choices"][0]["message"]
        calls = []
        for tc in msg.get("tool_calls") or []:
            args = tc["function"].get("arguments", {})
            if isinstance(args, str):
                args = json.loads(args or "{}")
            calls.append({"name": tc["function"]["name"], "arguments": args})
        return msg.get("content") or "", calls


class ProviderRegistry:
    """Singleton over configured providers (reference providers.py:42-486)."""

    _instance: "ProviderRegistry | None" = None
    _lock = threading.Lock()

    def __init__(self, providers: list[ProviderConfig]):
        self.providers = {p.id: p for p in providers}
        self._model_cache: dict[str, tuple[float, list[str]]] = {}
        self._capability_cache: dict[tuple, tuple[float, bool]] = {}

    @classmethod
    def get_instance(cls, providers: list[ProviderConfig] | None = None) -> "ProviderRegistry":
        """Singleton accessor. ``providers`` seeds CONSTRUCTION only — an
        existing instance is returned as-is (rebuilding on every call would
        discard the model/capability TTL caches each status poll). Mutating
        provider config must call ``reset_instance()`` (the provider CRUD
        routes do), after which the next call rebuilds."""
        with cls._lock:
            if cls._instance is None:
                if providers is None:
                    from tensortruth_tpu_torch.app.config import load_config

                    providers = load_config().providers
                cls._instance = cls(providers)
            return cls._instance

    @classmethod
    def reset_instance(cls) -> None:
        with cls._lock:
            cls._instance = None

    def get_provider(self, provider_id: str) -> ProviderConfig | None:
        return self.providers.get(provider_id)

    def probe_models(self, provider_id: str) -> list[str]:
        """Live model discovery that RAISES on an unreachable provider —
        the connectivity-test surface (/api/providers/test must report a
        dead server as ok=false, not an empty success)."""
        p = self.providers.get(provider_id)
        if p is None:
            raise KeyError(f"unknown provider: {provider_id}")
        if p.type == "ollama":
            return OllamaLLM(p.base_url, "").list_models()
        static = [m.get("name") or m.get("id") for m in p.models if isinstance(m, dict)]
        return static or OpenAICompatibleLLM(
            p.base_url, "", api_key=p.api_key
        ).list_models()

    def list_models(self, provider_id: str, ttl: float = CAPABILITY_CACHE_TTL) -> list[str]:
        now = time.time()
        cached = self._model_cache.get(provider_id)
        if cached and now - cached[0] < ttl:
            return cached[1]
        p = self.providers.get(provider_id)
        if p is None:
            return []
        try:
            models = self.probe_models(provider_id)
        except Exception as e:
            logger.warning("model discovery failed for %s: %s", provider_id, e)
            models = [m.get("name") or m.get("id") for m in p.models if isinstance(m, dict)]
        self._model_cache[provider_id] = (now, models)
        return models

    def resolve_model(
        self, model: str | None, provider_id: str | None = None
    ) -> ModelReference | None:
        """Fallback chain (reference providers.py:237-284): explicit
        provider+model → search providers for the model → first available."""
        order = (
            [provider_id] if provider_id and provider_id in self.providers
            else list(self.providers)
        )
        if model:
            for pid in order:
                if model in self.list_models(pid) or not self.list_models(pid):
                    return ModelReference(pid, model)
            return ModelReference(order[0], model) if order else None
        for pid in order:
            models = self.list_models(pid)
            if models:
                return ModelReference(pid, models[0])
        return None

    def check_capability(
        self, ref: ModelReference, capability: str
    ) -> bool:
        """tools/thinking probe with TTL cache (reference providers.py:388-433).

        Ollama: POST /api/show and inspect capabilities; others: declared
        default_capabilities on the provider config.
        """
        key = (ref.provider_id, ref.model, capability)
        now = time.time()
        cached = self._capability_cache.get(key)
        if cached and now - cached[0] < CAPABILITY_CACHE_TTL:
            return cached[1]
        p = self.providers.get(ref.provider_id)
        result = False
        if p is not None:
            if capability in (p.default_capabilities or []):
                result = True
            elif p.type == "ollama":
                try:
                    import requests

                    r = requests.post(
                        f"{p.base_url.rstrip('/')}/api/show",
                        json={"model": ref.model},
                        timeout=10,
                    )
                    r.raise_for_status()
                    result = capability in (r.json().get("capabilities") or [])
                except Exception:
                    result = False
        self._capability_cache[key] = (now, result)
        return result


def create_llm(
    params: dict,
    providers: list[ProviderConfig] | None = None,
) -> BaseLLM:
    """Dispatch per provider type (reference providers.py:494-589).

    params: {model, provider_id, temperature, context_window, max_tokens,
    thinking}.
    """
    registry = ProviderRegistry.get_instance(providers)
    ref = registry.resolve_model(params.get("model"), params.get("provider_id"))
    if ref is None:
        raise ValueError("no provider/model available")
    p = registry.get_provider(ref.provider_id)
    kw = dict(
        temperature=params.get("temperature", 0.7),
        context_window=params.get("context_window", 8192),
        max_tokens=params.get("max_tokens", 4096),
        timeout=p.timeout,
        thinking=params.get("thinking"),
        api_key=p.api_key,
    )
    if p.type == "ollama":
        return OllamaLLM(p.base_url, ref.model, **kw)
    if p.type == "llama_cpp":
        kw["extra_payload"] = _llama_cpp_thinking_params(kw["thinking"])
    return OpenAICompatibleLLM(p.base_url, ref.model, **kw)


def _llama_cpp_thinking_params(thinking) -> dict:
    """Translate the thinking preference into llama.cpp request params
    (reference providers.py:564-589): off → reasoning_format "none";
    level strings map to deepseek format with a think budget (low 1024,
    medium 4096, high unlimited); any other truthy value → deepseek."""
    if thinking is None:
        return {}
    if thinking is False:
        return {"reasoning_format": "none"}
    budgets = {"low": 1024, "medium": 4096, "high": -1}
    if isinstance(thinking, str) and thinking in budgets:
        return {"reasoning_format": "deepseek", "think_budget": budgets[thinking]}
    if thinking:
        return {"reasoning_format": "deepseek"}
    return {}


_llm_cache: dict[tuple, BaseLLM] = {}


def get_orchestrator_llm(params: dict) -> BaseLLM:
    """Low-temperature, thinking-off agent loop LLM (reference :603-632)."""
    key = ("orch", params.get("provider_id"), params.get("model"), params.get("context_window"))
    if key not in _llm_cache:
        _llm_cache[key] = create_llm({**params, "temperature": 0.2, "thinking": False})
    return _llm_cache[key]


def get_tool_llm(params: dict) -> BaseLLM:
    """Synthesis/tool LLM: temp 0.7, thinking auto (reference :635-679)."""
    key = ("tool", params.get("provider_id"), params.get("model"), params.get("context_window"))
    if key not in _llm_cache:
        _llm_cache[key] = create_llm({**params, "temperature": 0.7})
    return _llm_cache[key]


def clear_llm_cache() -> None:
    _llm_cache.clear()
