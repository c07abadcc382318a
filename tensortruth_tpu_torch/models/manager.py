"""Model lifecycle manager: one embedder + one reranker resident per process.

Port of ``tensortruth_tpu/models/manager.py``: a thread-safe singleton;
identity key = (model id, dtype, max length, checkpoint dir, tokenizer,
buckets, placement), a mismatch swaps the resident model; loading resolves a
local HF checkpoint (``discover_checkpoint`` order), else random-init weights
at the architecture's full width. The placement is the device, or on a mesh
the mesh's shape and slot devices (the reference's ``_mesh_desc``: a value,
so a config-driven mesh built anew per engine load reuses the model). The
reference's reuse rule holds for both: with neither ``device`` nor ``mesh``
("don't care") the resident model is reused wherever it is (else loaded on
``cuda``); a named device (``cuda`` meaning the current card, ``cuda:N``)
or a mesh must match. On a mesh the model loads on its lead device and is
replicated to the others by the runtime. Nothing moves on its own.
The reference's XLA compilation-cache helpers have no counterpart here:
PyTorch runs eagerly.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, replace
from pathlib import Path

import torch

from tensortruth_tpu_torch.tokenization import load_tokenizer
from tensortruth_tpu_torch.utils import profiling
from tensortruth_tpu_torch.models.embedder import Embedder
from tensortruth_tpu_torch.models.reranker import Reranker
from tensortruth_tpu_torch.models.xlmr import (
    BGE_M3_CONFIG,
    BGE_RERANKER_V2_M3_CONFIG,
    XLMRConfig,
)

logger = logging.getLogger(__name__)

DEFAULT_EMBEDDING_MODEL = "BAAI/bge-m3"
DEFAULT_RERANKER_MODEL = "BAAI/bge-reranker-v2-m3"

# Architectures known by HF model id. ``tiny-*`` ids exist for tests.
_EMBEDDER_ARCHS: dict[str, XLMRConfig] = {
    DEFAULT_EMBEDDING_MODEL: BGE_M3_CONFIG,
    "tiny-embedder": XLMRConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position=130,
    ),
}
_RERANKER_ARCHS: dict[str, XLMRConfig] = {
    DEFAULT_RERANKER_MODEL: BGE_RERANKER_V2_M3_CONFIG,
    "tiny-reranker": XLMRConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position=130, num_labels=1,
    ),
}


def discover_checkpoint(model_id: str) -> tuple[str | None, str | None]:
    """Local weights + tokenizer for ``model_id``, no network. First hit of:
    ``$TENSOR_TRUTH_TPU_MODELS_DIR/<model_id|name>/``, then the HF hub cache
    (``$HF_HUB_CACHE``, ``$HF_HOME/hub``, ``~/.cache/huggingface/hub``),
    current revision first. Returns (model_dir, tokenizer_json), either may
    be None."""
    roots: list[Path] = []
    env_dir = os.environ.get("TENSOR_TRUTH_TPU_MODELS_DIR")
    if env_dir:
        roots.append(Path(env_dir))
    hub = os.environ.get("HF_HUB_CACHE")
    if not hub:
        hf_home = os.environ.get("HF_HOME")
        hub = os.path.join(hf_home, "hub") if hf_home else None
    roots.append(Path(hub) if hub else Path.home() / ".cache/huggingface/hub")

    def weights_in(d: Path) -> bool:
        return (
            (d / "model.safetensors").exists()
            or (d / "model.safetensors.index.json").exists()
            or (d / "pytorch_model.bin").exists()
        )

    def snapshots_ordered(repo_dir: Path) -> list[Path]:
        snaps = [p for p in (repo_dir / "snapshots").iterdir() if p.is_dir()]
        ref = repo_dir / "refs" / "main"
        if ref.exists():
            head = ref.read_text().strip()
            snaps.sort(key=lambda p: (p.name != head, -p.stat().st_mtime))
        else:
            snaps.sort(key=lambda p: -p.stat().st_mtime)
        return snaps

    candidates: list[Path] = []
    sanitized = model_id.split("/")[-1]
    for root in roots:
        if not root.is_dir():
            continue
        candidates += [root / model_id, root / sanitized]
        repo_dir = root / f"models--{model_id.replace('/', '--')}"
        if (repo_dir / "snapshots").is_dir():
            candidates += snapshots_ordered(repo_dir)

    for d in candidates:
        if d.is_dir() and weights_in(d):
            tok = d / "tokenizer.json"
            return str(d), str(tok) if tok.exists() else None
    for d in candidates:
        if d.is_dir() and (d / "tokenizer.json").exists():
            return None, str(d / "tokenizer.json")
    return None, None


@dataclass
class ModelSpec:
    model_id: str
    dtype: str = "bfloat16"
    max_length: int = 2048  # the chunker's largest (level-0) node
    local_dir: str | None = None
    tokenizer_path: str | None = None
    batch_buckets: tuple | None = None
    seq_buckets: tuple | None = None

    def key(self) -> tuple:
        return (
            self.model_id, self.dtype, self.max_length,
            self.local_dir, self.tokenizer_path,
            self.batch_buckets, self.seq_buckets,
        )

    def bucket_kwargs(self) -> dict:
        kw = {}
        if self.batch_buckets:
            kw["batch_buckets"] = tuple(self.batch_buckets)
        if self.seq_buckets:
            kw["seq_buckets"] = tuple(self.seq_buckets)
        return kw


def _clamp_max_length(spec: ModelSpec, cfg: XLMRConfig) -> ModelSpec:
    """Cap ``max_length`` at the position table: XLM-R positions start at
    pad_id + 1 = 2, BERT's at 0."""
    offset = 0 if cfg.position_style == "bert" else 2
    cap = max(cfg.max_position - offset, 8)
    return spec if spec.max_length <= cap else replace(spec, max_length=cap)


def _device_of(device) -> torch.device:
    """The device a model loads on: ``cuda`` for None, and a card with its
    index (``cuda`` is the current one), so one card has one key."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class ModelManager:
    """Process-wide singleton: one embedder + one reranker resident at a time."""

    _instance: "ModelManager | None" = None
    _instance_lock = threading.Lock()
    # model_id -> (expiry, (local_dir, tokenizer_path)); the filesystem scan
    # must not run per request
    _discovery_cache: dict[str, tuple[float, tuple]] = {}
    _DISCOVERY_TTL = 60.0

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._embedder: Embedder | None = None
        self._embedder_key: tuple | None = None
        self._reranker: Reranker | None = None
        self._reranker_key: tuple | None = None

    @classmethod
    def get_instance(cls) -> "ModelManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset_instance(cls) -> None:
        with cls._instance_lock:
            cls._instance = None

    @classmethod
    def _discover_cached(cls, model_id: str) -> tuple[str | None, str | None]:
        hit = cls._discovery_cache.get(model_id)
        now = time.monotonic()
        if hit and hit[0] > now:
            return hit[1]
        found = discover_checkpoint(model_id)
        cls._discovery_cache[model_id] = (now + cls._DISCOVERY_TTL, found)
        return found

    @classmethod
    def _resolve_spec(cls, spec: ModelSpec) -> ModelSpec:
        if spec.model_id.startswith("tiny-"):
            return spec  # test architectures are always random-init
        if spec.local_dir and not spec.tokenizer_path:
            tok = Path(spec.local_dir) / "tokenizer.json"
            if tok.exists():
                spec = replace(spec, tokenizer_path=str(tok))
        if spec.local_dir and spec.tokenizer_path:
            return spec
        local_dir, tok = cls._discover_cached(spec.model_id)
        return replace(
            spec,
            local_dir=spec.local_dir or local_dir,
            tokenizer_path=spec.tokenizer_path or tok,
        )

    @staticmethod
    def _resolve_arch(spec: ModelSpec, registry: dict, default: XLMRConfig, num_labels: int) -> XLMRConfig:
        """Registry id -> the checkpoint's own config.json -> BGE default."""
        cfg = registry.get(spec.model_id)
        if cfg is not None:
            return cfg
        if spec.local_dir:
            from tensortruth_tpu_torch.models.convert import config_from_hf

            cfg = config_from_hf(spec.local_dir, num_labels=num_labels)
            if cfg is not None:
                return cfg
        if spec.model_id not in (DEFAULT_EMBEDDING_MODEL, DEFAULT_RERANKER_MODEL):
            logger.warning(
                "%s: unknown architecture and no readable config.json — assuming "
                "the BGE default (XLM-R %d-layer)", spec.model_id, default.num_layers,
            )
        return default

    def _load(self, spec: ModelSpec, device, role: str, mesh=None):
        """Build an Embedder or Reranker for ``spec`` on ``device`` (a mesh's
        lead device, the runtime replicating it over ``mesh``), as set-up
        phase ``models`` of ``profiling.SETUP``, which also keeps each role's
        ``<role>_s`` and its parts ``<role>_tokenizer_s`` and
        ``<role>_weights_s`` (the checkpoint read or the weights drawn, and
        the runtime seated on the device)."""
        setup = profiling.SETUP
        clock = setup.clock
        with setup.phase("model", "models"):
            t0 = clock()
            if role == "embedder":
                cfg = self._resolve_arch(spec, _EMBEDDER_ARCHS, BGE_M3_CONFIG, 0)
                runtime = Embedder
            else:
                cfg = self._resolve_arch(spec, _RERANKER_ARCHS, BGE_RERANKER_V2_M3_CONFIG, 1)
                runtime = Reranker
            spec = _clamp_max_length(spec, cfg)
            dtype = getattr(torch, spec.dtype)
            if spec.tokenizer_path is None and not spec.model_id.startswith("tiny-"):
                logger.warning(
                    "%s %s: no tokenizer.json found — using the hash-based "
                    "SimpleTokenizer; scores will not match the real model",
                    role, spec.model_id,
                )
            tokenizer = load_tokenizer(
                spec.tokenizer_path, sep_style="bert" if cfg.position_style == "bert" else "xlmr"
            )
            t1 = clock()
            kw = dict(max_length=spec.max_length, mesh=mesh, **spec.bucket_kwargs())
            if spec.local_dir:
                from tensortruth_tpu_torch.models.convert import load_local_checkpoint

                model = runtime(load_local_checkpoint(spec.local_dir, cfg, device, dtype), tokenizer, **kw)
            else:
                logger.warning("no local checkpoint for %s — using random-init weights", spec.model_id)
                model = runtime.random_init(cfg, tokenizer, device, dtype=dtype, **kw)
            model.model_id = spec.model_id
            t2 = clock()
            setup.add(**{f"{role}_s": t2 - t0, f"{role}_tokenizer_s": t1 - t0, f"{role}_weights_s": t2 - t1})
        return model

    @staticmethod
    def _key_matches(resident_key, spec: ModelSpec, device, mesh=None) -> bool:
        """Neither device nor mesh means "don't care": callers off the engine
        path (document uploads, web reranking) reuse the resident model
        rather than load a second copy of it."""
        if resident_key is None:
            return False
        if mesh is not None:
            return resident_key == (*spec.key(), mesh.describe())
        if device is None:
            return resident_key[:-1] == spec.key()
        return resident_key == (*spec.key(), str(_device_of(device)))

    def _get(self, role: str, spec: ModelSpec, device, mesh):
        """The resident ``role`` model if its key matches, else load it."""
        with self._lock:
            model, key = getattr(self, f"_{role}"), getattr(self, f"_{role}_key")
            if model is not None and self._key_matches(key, spec, device, mesh):
                return model
            device = mesh.lead if mesh is not None else _device_of(device)
            new_key = (*spec.key(), mesh.describe() if mesh is not None else str(device))
            if model is not None:
                logger.info("swapping %s %s -> %s", role, key, new_key)
                setattr(self, f"_{role}", None)  # release device memory before loading
            setattr(self, f"_{role}", self._load(spec, device, role, mesh))
            setattr(self, f"_{role}_key", new_key)
            return getattr(self, f"_{role}")

    def get_embedder(self, spec: ModelSpec | None = None, device=None, mesh=None) -> Embedder:
        return self._get("embedder", self._resolve_spec(spec or ModelSpec(DEFAULT_EMBEDDING_MODEL)), device, mesh)

    def get_reranker(self, spec: ModelSpec | None = None, device=None, mesh=None) -> Reranker:
        return self._get("reranker", self._resolve_spec(spec or ModelSpec(DEFAULT_RERANKER_MODEL)), device, mesh)

    def unload_all(self) -> None:
        with self._lock:
            self._embedder = self._embedder_key = None
            self._reranker = self._reranker_key = None

    def status(self) -> dict:
        with self._lock:
            def entry(model, key):
                if model is None:
                    return None
                return {
                    "key": list(key),
                    "param_bytes": model.param_bytes(),
                    "param_gb": round(model.param_bytes() / 2**30, 3),
                }

            devices = [
                {
                    "id": i,
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(i),
                    "memory_allocated": torch.cuda.memory_allocated(i),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(i),
                }
                for i in range(torch.cuda.device_count())
            ]
            return {
                "embedder": entry(self._embedder, self._embedder_key),
                "reranker": entry(self._reranker, self._reranker_key),
                "devices": devices,
            }


def register_embedder_arch(model_id: str, cfg: XLMRConfig) -> None:
    _EMBEDDER_ARCHS[model_id] = cfg


def register_reranker_arch(model_id: str, cfg: XLMRConfig) -> None:
    _RERANKER_ARCHS[model_id] = cfg
