"""Legacy index-layout migration.

Mirrors reference indexing/migration.py:25-212: detects the flat
``indexes/{module}`` layout (pre model-scoped dirs), moves each module under
``indexes/{default_model_id}/{module}`` and stamps ``index_metadata.json``;
runs once at startup (reference startup_service.py:108).
"""

from __future__ import annotations

import datetime
import json
import logging
import shutil
from pathlib import Path

from tensortruth_tpu_torch.index.store import (
    EMB_FILE,
    INDEX_VERSION,
    METADATA_FILE,
    sanitize_model_id,
)

logger = logging.getLogger(__name__)


def detect_legacy_indexes(base_indexes_dir: str | Path) -> list[Path]:
    """Flat module dirs = directories holding embeddings.npy directly under
    ``indexes/`` (model-scoped dirs hold module subdirs instead)."""
    base = Path(base_indexes_dir)
    if not base.exists():
        return []
    return [
        d for d in base.iterdir() if d.is_dir() and (d / EMB_FILE).exists()
    ]


def migrate_legacy_indexes(
    base_indexes_dir: str | Path, default_model: str = "BAAI/bge-m3"
) -> list[str]:
    """Move flat module dirs under indexes/{model_id}/; returns moved names."""
    base = Path(base_indexes_dir)
    legacy = detect_legacy_indexes(base)
    if not legacy:
        return []
    model_dir = base / sanitize_model_id(default_model)
    model_dir.mkdir(parents=True, exist_ok=True)
    moved = []
    for d in legacy:
        target = model_dir / d.name
        if target.exists():
            logger.warning("migration target exists, skipping %s", d.name)
            continue
        shutil.move(str(d), str(target))
        meta_path = target / METADATA_FILE
        if not meta_path.exists():
            meta_path.write_text(
                json.dumps(
                    {
                        "embedding_model": default_model,
                        "created_at": datetime.datetime.now(
                            datetime.timezone.utc
                        ).isoformat(),
                        "index_version": INDEX_VERSION,
                        "migrated_from": "legacy-flat-layout",
                    },
                    indent=2,
                )
            )
        moved.append(d.name)
    logger.info("migrated %d legacy indexes: %s", len(moved), moved)
    return moved


def check_and_migrate_on_startup(base_indexes_dir: str | Path, default_model: str) -> list[str]:
    try:
        return migrate_legacy_indexes(base_indexes_dir, default_model)
    except Exception as e:  # migration must never block startup
        logger.error("legacy migration failed: %s", e)
        return []
