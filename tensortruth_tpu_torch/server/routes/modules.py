"""Module catalog + model listing routes (reference api/routes/modules.py:52-154)."""

from __future__ import annotations

from aiohttp import web

from tensortruth_tpu_torch.app.paths import get_base_indexes_dir
from tensortruth_tpu_torch.indexing.metadata import (
    list_available_models,
    list_modules_for_model,
    read_index_metadata,
)


def _count_rows(mod_dir) -> int | None:
    """Leaf-chunk count without loading embeddings: shard manifest n_rows,
    else the .npy header shape via mmap."""
    import json

    manifest = mod_dir / "embeddings.manifest.json"
    if manifest.exists():
        try:
            return int(json.loads(manifest.read_text())["n_rows"])
        except Exception:
            return None
    npy = mod_dir / "embeddings.npy"
    if npy.exists():
        try:
            import numpy as np

            return int(np.load(npy, mmap_mode="r").shape[0])
        except Exception:
            return None
    return None


async def list_modules(request: web.Request):
    services = request.app["services"]
    model = request.query.get(
        "embedding_model", services.config.rag.default_embedding_model
    )
    base = get_base_indexes_dir()
    modules = []
    for name in list_modules_for_model(base, model):
        from tensortruth_tpu_torch.index.store import sanitize_model_id

        mod_dir = base / sanitize_model_id(model) / name
        meta = read_index_metadata(mod_dir) or {}
        doc_type, _, module = name.partition("_")
        modules.append(
            {
                "id": name,
                "module": module or name,
                "doc_type": doc_type,
                "embedding_model": meta.get("embedding_model", model),
                "created_at": meta.get("created_at"),
                "chunking_strategy": meta.get("chunking_strategy"),
                "n_chunks": _count_rows(mod_dir),
            }
        )
    return web.json_response({"modules": modules})


async def list_embedding_models(request: web.Request):
    return web.json_response(
        {"models": list_available_models(get_base_indexes_dir())}
    )


async def list_llm_models(request: web.Request):
    from tensortruth_tpu_torch.core.providers import ProviderRegistry

    services = request.app["services"]
    registry = ProviderRegistry.get_instance(services.config.providers)
    out = []
    for pid in registry.providers:
        for m in registry.list_models(pid):
            out.append({"provider_id": pid, "model": m})
    return web.json_response({"models": out})


def setup(app: web.Application) -> None:
    app.router.add_get("/api/modules", list_modules)
    app.router.add_get("/api/embedding-models", list_embedding_models)
    app.router.add_get("/api/models", list_llm_models)
