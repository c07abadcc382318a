"""Cross-platform path layout for user data.

Mirrors the reference's `~/.tensortruth/` layout (reference
app_utils/paths.py:10-144,259-304) under `~/.tensortruth_tpu/`:

    config.yaml
    sources.json
    library_docs/{library|papers|book}_<name>/
    indexes/<embedding_model_id>/<doc_type>_<module>/   (VectorIndex dirs)
    sessions/<id>/{session.json, pdfs, markdown, index, images}
    projects/<id>/{project.json, documents, markdown, index}

Env-var overrides (reference paths.py:150-256):
    TENSOR_TRUTH_TPU_DATA_DIR, TENSOR_TRUTH_TPU_DOCS_DIR,
    TENSOR_TRUTH_TPU_SOURCES_CONFIG, TENSOR_TRUTH_TPU_INDEXES_DIR
"""

from __future__ import annotations

import os
from pathlib import Path

from tensortruth_tpu_torch.index.store import sanitize_model_id

ENV_DATA_DIR = "TENSOR_TRUTH_TPU_DATA_DIR"
ENV_DOCS_DIR = "TENSOR_TRUTH_TPU_DOCS_DIR"
ENV_SOURCES = "TENSOR_TRUTH_TPU_SOURCES_CONFIG"
ENV_INDEXES = "TENSOR_TRUTH_TPU_INDEXES_DIR"


def get_user_data_dir() -> Path:
    base = os.environ.get(ENV_DATA_DIR)
    data_dir = Path(base) if base else Path.home() / ".tensortruth_tpu"
    data_dir.mkdir(parents=True, exist_ok=True)
    return data_dir


def get_config_path() -> Path:
    return get_user_data_dir() / "config.yaml"


def get_sources_config_path() -> Path:
    p = os.environ.get(ENV_SOURCES)
    return Path(p) if p else get_user_data_dir() / "sources.json"


def get_library_docs_dir() -> Path:
    p = os.environ.get(ENV_DOCS_DIR)
    d = Path(p) if p else get_user_data_dir() / "library_docs"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_base_indexes_dir() -> Path:
    p = os.environ.get(ENV_INDEXES)
    d = Path(p) if p else get_user_data_dir() / "indexes"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_indexes_dir_for_model(model_id: str) -> Path:
    d = get_base_indexes_dir() / sanitize_model_id(model_id)
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_module_index_dir(model_id: str, doc_type: str, module: str) -> Path:
    """indexes/{model_id}/{doc_type}_{module} (reference builder.py:315-321)."""
    return get_indexes_dir_for_model(model_id) / f"{doc_type}_{module}"


# -- sessions -----------------------------------------------------------------


def get_sessions_data_dir() -> Path:
    d = get_user_data_dir() / "sessions"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_session_dir(session_id: str) -> Path:
    d = get_sessions_data_dir() / session_id
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_sessions_index_file() -> Path:
    return get_sessions_data_dir() / "sessions_index.json"


def get_session_data_file(session_id: str) -> Path:
    return get_sessions_data_dir() / session_id / "session.json"


def get_session_pdfs_dir(session_id: str) -> Path:
    d = get_session_dir(session_id) / "pdfs"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_session_markdown_dir(session_id: str) -> Path:
    d = get_session_dir(session_id) / "markdown"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_session_index_dir(session_id: str) -> Path:
    d = get_session_dir(session_id) / "index"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_session_images_dir(session_id: str) -> Path:
    d = get_session_dir(session_id) / "images"
    d.mkdir(parents=True, exist_ok=True)
    return d


# -- projects -----------------------------------------------------------------


def get_projects_data_dir() -> Path:
    d = get_user_data_dir() / "projects"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_project_dir(project_id: str) -> Path:
    d = get_projects_data_dir() / project_id
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_project_data_file(project_id: str) -> Path:
    return get_projects_data_dir() / project_id / "project.json"


def get_project_documents_dir(project_id: str) -> Path:
    d = get_project_dir(project_id) / "documents"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_project_markdown_dir(project_id: str) -> Path:
    d = get_project_dir(project_id) / "markdown"
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_project_index_dir(project_id: str) -> Path:
    d = get_project_dir(project_id) / "index"
    d.mkdir(parents=True, exist_ok=True)
    return d
