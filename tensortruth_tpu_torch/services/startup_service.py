"""Startup checks: directories, config, indexes, migration, providers.

Mirrors reference services/startup_service.py:21-130+: first-run directory +
config initialization, index presence check with legacy migration trigger,
embedding-model mismatch detection, provider reachability probe.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


@dataclass
class StartupStatus:
    first_run: bool = False
    config_ok: bool = False
    indexes_present: bool = False
    index_count: int = 0
    migrated: list[str] = field(default_factory=list)
    embedding_model_mismatch: bool = False
    available_models: list[str] = field(default_factory=list)
    providers_reachable: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "first_run": self.first_run,
            "config_ok": self.config_ok,
            "indexes_present": self.indexes_present,
            "index_count": self.index_count,
            "migrated": self.migrated,
            "embedding_model_mismatch": self.embedding_model_mismatch,
            "available_models": self.available_models,
            "providers_reachable": self.providers_reachable,
        }


class StartupService:
    def __init__(self, config=None):
        self.config = config

    def check_startup_status(self, probe_providers: bool = False) -> StartupStatus:
        from tensortruth_tpu_torch.app.config import load_config
        from tensortruth_tpu_torch.app.paths import (
            get_base_indexes_dir,
            get_config_path,
        )
        from tensortruth_tpu_torch.indexing.metadata import (
            list_available_models,
            list_modules_for_model,
        )
        from tensortruth_tpu_torch.indexing.migration import check_and_migrate_on_startup

        status = StartupStatus()
        status.first_run = not get_config_path().exists()
        config = self.config or load_config()  # creates on first run
        status.config_ok = True

        base = get_base_indexes_dir()
        default_model = config.rag.default_embedding_model
        status.migrated = check_and_migrate_on_startup(base, default_model)

        status.available_models = list_available_models(base)
        modules = list_modules_for_model(base, default_model)
        status.index_count = len(modules)
        status.indexes_present = bool(modules)
        # Indexes exist, but none for the configured model → mismatch
        # (reference startup_service embedding-model mismatch detection).
        from tensortruth_tpu_torch.index.store import sanitize_model_id

        status.embedding_model_mismatch = bool(status.available_models) and (
            sanitize_model_id(default_model) not in status.available_models
        )

        if probe_providers:
            from tensortruth_tpu_torch.core.providers import ProviderRegistry

            registry = ProviderRegistry.get_instance(config.providers)
            for pid in registry.providers:
                try:
                    models = registry.list_models(pid, ttl=0)
                    status.providers_reachable[pid] = bool(models)
                except Exception:
                    status.providers_reachable[pid] = False
        return status
