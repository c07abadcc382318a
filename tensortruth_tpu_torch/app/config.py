"""Layered configuration: dataclass schema + YAML persistence.

Mirrors the reference's config system (reference app_utils/config_schema.py,
app_utils/config.py:34-58): per-section defaults, create-on-first-run,
corrupted-file → defaults, `${ENV_VAR}` expansion at read time (never written
back), and the same YAML section names so configs diff cleanly. CUDA-specific
knobs (torch_dtype, flash_attention, batch_size_cuda) are replaced by their
TPU-native equivalents (jax dtype, batch/sequence buckets, mesh shape).
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import asdict, dataclass, field, fields
from pathlib import Path

logger = logging.getLogger(__name__)

# Behavioral constant reproduced verbatim from the reference's
# history-cleaning contract (reference config_schema.py:190-198): these
# exact regexes define which filler openers the cleaner strips, and
# diverging from them would change cleaned-history parity.
DEFAULT_FILLER_PHRASES = [
    r"(?i)^(great|good|excellent)\s+(question|point)[!.]*\s*",
    r"(?i)^i['']?d be happy to help[!.]*\s*",
    r"(?i)^let me (think|see|help)[^.]*[.!]*\s*",
    r"(?i)^(sure|certainly|absolutely)[!.,]*\s*",
    r"(?i)if you have any (more |other )?questions[^.]*[.!]*\s*$",
    r"(?i)feel free to ask[^.]*[.!]*\s*$",
    r"(?i)hope this helps[!.]*\s*$",
]

DEFAULT_RERANKER_MODELS = [
    "BAAI/bge-reranker-v2-m3",
]


def _from_dict(cls, data: dict):
    """Tolerant dataclass hydration: ignore unknown keys."""
    known = {f.name for f in fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in known})


@dataclass
class ProviderConfig:
    """One LLM provider endpoint (reference config_schema.py:18-27)."""

    id: str = "ollama"
    type: str = "ollama"  # "ollama" | "openai_compatible" | "llama_cpp"
    base_url: str = "http://localhost:11434"
    api_key: str = ""  # supports ${ENV_VAR}
    timeout: int = 300
    models: list = field(default_factory=list)
    default_capabilities: list = field(default_factory=list)


@dataclass
class OllamaConfig:
    base_url: str = "http://localhost:11434"
    timeout: int = 300


@dataclass
class LLMConfig:
    default_model: str = ""
    default_temperature: float = 0.7
    default_context_window: int = 8192
    default_max_tokens: int = 4096


@dataclass
class EmbeddingModelConfig:
    """Per-embedding-model TPU tuning (replaces reference
    config_schema.py:41-79 CUDA knobs)."""

    # None = the runtime's measured-tuned buckets (models/embedder.py,
    # models/reranker.py); set explicit lists to trade compile count vs
    # padding waste for a non-default model.
    batch_buckets: list | None = None
    seq_buckets: list | None = None
    dtype: str = "bfloat16"
    max_length: int = 2048  # = largest chunk level; BGE-M3 supports up to 8192
    local_dir: str | None = None  # local HF checkpoint for weight conversion
    tokenizer_path: str | None = None


DEFAULT_EMBEDDING_MODEL_CONFIGS: dict[str, dict] = {
    "BAAI/bge-m3": asdict(EmbeddingModelConfig()),
}


@dataclass
class MeshConfig:
    """Device-mesh layout for the retrieval engine (new — no reference
    analog; SURVEY.md §2.14)."""

    n_data: int = 1  # DP axis size (query batching)
    n_shards: int = 0  # corpus-shard axis; 0 = all remaining devices
    enabled: bool = False  # single-device default; flip on for slices


@dataclass
class RAGConfig:
    default_device: str = "tpu"
    default_balance_strategy: str = "top_k_per_index"
    default_embedding_model: str = "BAAI/bge-m3"
    default_reranker: str = "BAAI/bge-reranker-v2-m3"
    default_top_n: int = 5
    default_confidence_threshold: float = 0.35
    default_confidence_cutoff_hard: float = 0.05
    embedding_model_configs: dict = field(default_factory=dict)
    reranker_models: list = field(default_factory=list)
    mesh: dict = field(default_factory=lambda: asdict(MeshConfig()))
    use_fused_topk: bool | None = None  # None = auto (fused on TPU)
    corpus_dtype: str = "bfloat16"  # "int8" halves HBM per chunk (~0 recall cost)
    # Server-side query micro-batching (services/batcher.py): coalesce
    # concurrent retrievals into one device dispatch.
    query_batching: bool = True
    query_batching_max_wait_ms: float = 8.0
    query_batching_max_batch: int = 32
    # Worker-pool host feeding for the rerank tokenize stage
    # (services/feeder.py): -1 = auto (one worker per host core), 0/1 =
    # single-threaded. The 8-chip DP serving shape needs the host term
    # sharded across cores to stay inside the device budget (BASELINE.md
    # host-feeding table).
    host_feed_workers: int = -1

    def get_embedding_model_config(self, model_name: str) -> EmbeddingModelConfig:
        if model_name in self.embedding_model_configs:
            return _from_dict(EmbeddingModelConfig, self.embedding_model_configs[model_name])
        if model_name in DEFAULT_EMBEDDING_MODEL_CONFIGS:
            return _from_dict(EmbeddingModelConfig, DEFAULT_EMBEDDING_MODEL_CONFIGS[model_name])
        return EmbeddingModelConfig()

    def get_reranker_models(self) -> list:
        return self.reranker_models or list(DEFAULT_RERANKER_MODELS)


@dataclass
class ConversationConfig:
    max_history_turns: int = 3
    memory_token_limit: int = 4000


@dataclass
class AgentConfig:
    max_iterations: int = 10
    min_pages_required: int = 5
    orchestrator_enabled: bool = True
    show_orchestrator_reasoning: bool = False

    def __post_init__(self):
        if self.max_iterations <= 0:
            raise ValueError(f"max_iterations must be positive, got {self.max_iterations}")
        if self.min_pages_required < 1:
            raise ValueError(
                f"min_pages_required must be at least 1, got {self.min_pages_required}"
            )


@dataclass
class HistoryCleaningConfig:
    enabled: bool = True
    remove_emojis: bool = True
    remove_filler_phrases: bool = True
    normalize_whitespace: bool = True
    collapse_newlines: bool = True
    filler_phrases: list = field(default_factory=lambda: list(DEFAULT_FILLER_PHRASES))


@dataclass
class WebSearchConfig:
    ddg_max_results: int = 10
    max_pages_to_fetch: int = 5
    enable_title_reranking: bool = True
    enable_content_reranking: bool = True
    rerank_title_threshold: float = 0.1
    rerank_content_threshold: float = 0.1
    max_source_context_pct: float = 0.15
    input_context_pct: float = 0.6
    citation_style: str = "hyperlink"  # "hyperlink" [Title](url) | "bracket" [Source N]
    discover_links: bool = True  # append outbound-link suggestions to fetches


@dataclass
class TensorTruthTPUConfig:
    ollama: OllamaConfig = field(default_factory=OllamaConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    rag: RAGConfig = field(default_factory=RAGConfig)
    conversation: ConversationConfig = field(default_factory=ConversationConfig)
    agent: AgentConfig = field(default_factory=AgentConfig)
    history_cleaning: HistoryCleaningConfig = field(default_factory=HistoryCleaningConfig)
    web_search: WebSearchConfig = field(default_factory=WebSearchConfig)
    providers: list[ProviderConfig] = field(default_factory=list)
    extension_catalog_url: str = ""

    def to_dict(self) -> dict:
        return {
            "providers": [asdict(p) for p in self.providers],
            "llm": asdict(self.llm),
            "rag": asdict(self.rag),
            "conversation": asdict(self.conversation),
            "agent": asdict(self.agent),
            "history_cleaning": asdict(self.history_cleaning),
            "web_search": asdict(self.web_search),
            "extension_catalog_url": self.extension_catalog_url,
            "ollama": asdict(self.ollama),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "TensorTruthTPUConfig":
        providers = [
            _from_dict(ProviderConfig, p) for p in data.get("providers", [])
        ]
        if not providers:
            ollama = data.get("ollama", {})
            providers = [
                ProviderConfig(
                    id="ollama",
                    type="ollama",
                    base_url=ollama.get("base_url", "http://localhost:11434"),
                    timeout=ollama.get("timeout", 300),
                )
            ]
        return cls(
            ollama=_from_dict(OllamaConfig, data.get("ollama", {})),
            llm=_from_dict(LLMConfig, data.get("llm", {})),
            rag=_from_dict(RAGConfig, data.get("rag", {})),
            conversation=_from_dict(ConversationConfig, data.get("conversation", {})),
            agent=_from_dict(AgentConfig, data.get("agent", {})),
            history_cleaning=_from_dict(
                HistoryCleaningConfig, data.get("history_cleaning", {})
            ),
            web_search=_from_dict(WebSearchConfig, data.get("web_search", {})),
            providers=providers,
            extension_catalog_url=data.get("extension_catalog_url", ""),
        )

    @classmethod
    def default(cls) -> "TensorTruthTPUConfig":
        cfg = cls()
        cfg.providers = [ProviderConfig()]
        cfg.rag.embedding_model_configs = dict(DEFAULT_EMBEDDING_MODEL_CONFIGS)
        cfg.rag.reranker_models = list(DEFAULT_RERANKER_MODELS)
        return cfg


_ENV_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")


def expand_env_vars(value: str) -> str:
    """`${VAR}` → env value at read time only (reference config.py:12-21)."""
    return _ENV_RE.sub(lambda m: os.environ.get(m.group(1), m.group(0)), value)


def load_config(path: str | Path | None = None) -> TensorTruthTPUConfig:
    """Load config.yaml; create with defaults on first run; fall back to
    defaults when corrupted (reference config.py:34-58)."""
    import yaml

    from tensortruth_tpu_torch.app.paths import get_config_path

    path = Path(path) if path else get_config_path()
    if not path.exists():
        cfg = TensorTruthTPUConfig.default()
        save_config(cfg, path)
        return cfg
    try:
        data = yaml.safe_load(path.read_text()) or {}
        return TensorTruthTPUConfig.from_dict(data)
    except Exception as e:  # corrupted → defaults, never crash startup
        logger.warning("corrupted config %s (%s); using defaults", path, e)
        return TensorTruthTPUConfig.default()


def save_config(cfg: TensorTruthTPUConfig, path: str | Path | None = None) -> None:
    import yaml

    from tensortruth_tpu_torch.app.paths import get_config_path

    path = Path(path) if path else get_config_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".yaml.tmp")
    tmp.write_text(yaml.safe_dump(cfg.to_dict(), sort_keys=False))
    tmp.replace(path)
