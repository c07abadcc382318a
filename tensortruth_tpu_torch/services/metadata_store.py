"""Per-scope JSON persistence of extracted document metadata
(reference services/metadata_store.py:12-100)."""

from __future__ import annotations

from pathlib import Path

from tensortruth_tpu_torch.app.file_utils import atomic_write_json, read_json

STORE_FILE = "document_metadata.json"


class MetadataStore:
    def __init__(self, scope_dir: str | Path):
        self.path = Path(scope_dir) / STORE_FILE

    def _load(self) -> dict:
        return read_json(self.path, {})

    def get(self, doc_id: str) -> dict | None:
        return self._load().get(doc_id)

    def set(self, doc_id: str, metadata: dict) -> None:
        data = self._load()
        data[doc_id] = metadata
        atomic_write_json(self.path, data)

    def delete(self, doc_id: str) -> bool:
        data = self._load()
        if doc_id not in data:
            return False
        del data[doc_id]
        atomic_write_json(self.path, data)
        return True

    def all(self) -> dict:
        return self._load()
