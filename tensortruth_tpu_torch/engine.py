"""Engine factory: load per-module indexes + models into one retrieval engine.

Port of ``tensortruth_tpu/engine.py``: module index dirs (the shared
``VectorIndex`` format) stack into one ``MultiIndexEngine`` on ``device``;
the embedder and reranker come from the port's ``ModelManager``; adaptive
top-k ``similarity_top_k = max(5, 2 * reranker_top_n)``. On a mesh (the
``mesh`` argument, or ``rag.mesh.enabled`` in the config) the engine shards
the corpus over it and the embedder and reranker run data-parallel over
it; ``device`` becomes the mesh's lead device.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

from tensortruth_tpu_torch.index.store import VectorIndex, resolve_module_dir, sanitize_model_id
from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec
from tensortruth_tpu_torch.parallel.mesh import make_mesh
from tensortruth_tpu_torch.pipeline import QueryPipeline
from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine

logger = logging.getLogger(__name__)


@dataclass
class RAGEngine:
    """Everything the query path needs, loaded once per module set."""

    retriever: MultiIndexEngine
    embedder: object
    reranker: object | None
    modules: list[str]
    params: dict = field(default_factory=dict)
    pipeline: QueryPipeline | None = None  # fused embed -> top-k step

    @property
    def similarity_top_k(self) -> int:
        return self.retriever.similarity_top_k


def adaptive_top_k(reranker_top_n: int) -> int:
    """Retrieve 2x the rerank target, floor 5."""
    return max(5, reranker_top_n * 2)


def load_engine_for_modules(
    modules: list[str],
    params: dict | None = None,
    *,
    indexes_dir: str | Path | None = None,
    extra_index_paths: list[str | Path] | None = None,
    config=None,
    device="cuda",
    mesh=None,
) -> RAGEngine:
    """Load module indexes + models onto ``device`` into a ready RAGEngine.

    ``extra_index_paths`` are session/project document indexes (absolute
    VectorIndex dirs) attached beside catalog modules. ``rag.mesh.enabled``
    builds a mesh of the configured shape over every CUDA card when no
    ``mesh`` is passed."""
    from tensortruth_tpu_torch.app.config import load_config
    from tensortruth_tpu_torch.app.paths import get_base_indexes_dir

    params = dict(params or {})
    config = config or load_config()
    if mesh is None and config.rag.mesh.get("enabled"):
        mesh = make_mesh(n_shards=config.rag.mesh.get("n_shards") or None, n_data=config.rag.mesh.get("n_data", 1))
    if mesh is not None:
        device = mesh.lead
    embedding_model = params.get("embedding_model", config.rag.default_embedding_model)
    reranker_model = params.get("reranker_model", config.rag.default_reranker)
    top_n = params.get("reranker_top_n", config.rag.default_top_n)
    use_reranker = params.get("use_reranker", True)

    indexes_dir = Path(indexes_dir) if indexes_dir else get_base_indexes_dir()
    model_dir = indexes_dir / sanitize_model_id(embedding_model)

    indexes: dict[str, VectorIndex] = {}
    for module in modules:
        path = resolve_module_dir(model_dir, module)
        if path is None:
            logger.warning("module index not found, skipping: %s", module)
            continue
        try:  # per-module failure isolation
            indexes[module] = VectorIndex.load(path)
        except Exception as e:
            logger.error("module index %s unreadable (%s), skipping: %s", module, type(e).__name__, e)
            continue
        logger.info("loaded module %s (%d chunks)", module, indexes[module].n_alive)
    for p in extra_index_paths or []:
        p = Path(p)
        if VectorIndex.is_valid(p):
            # "{scope dir}/index": every scope's index dir is named "index"
            name = f"{p.parent.name}/{p.name}"
            try:
                indexes[name] = VectorIndex.load(p)
            except Exception as e:
                logger.error("document index %s unreadable, skipping: %s", p, e)

    manager = ModelManager.get_instance()
    mc = config.rag.get_embedding_model_config(embedding_model)
    embedder = manager.get_embedder(
        ModelSpec(
            embedding_model,
            dtype=mc.dtype,
            max_length=mc.max_length,
            local_dir=mc.local_dir,
            tokenizer_path=mc.tokenizer_path,
            batch_buckets=tuple(mc.batch_buckets) if mc.batch_buckets else None,
            seq_buckets=tuple(mc.seq_buckets) if mc.seq_buckets else None,
        ),
        device=device,
        mesh=mesh,
    )
    reranker = manager.get_reranker(ModelSpec(reranker_model), device=device, mesh=mesh) if use_reranker else None

    # An index embedded with one GELU flavour, queried with the other, carries
    # ~1e-3 activation error: detectable, not fatal.
    query_flavor = getattr(embedder, "gelu_flavor", "")
    for module, idx in indexes.items():
        built_flavor = idx.metadata.get("gelu", "")
        if built_flavor and query_flavor and built_flavor != query_flavor:
            logger.warning(
                "module %s was embedded with %s GELU but queries use %s GELU — "
                "rebuild the index or set approx_gelu to match",
                module, built_flavor, query_flavor,
            )

    retriever = MultiIndexEngine(
        indexes,
        similarity_top_k=adaptive_top_k(top_n),
        balance_strategy=params.get("balance_strategy", config.rag.default_balance_strategy),
        device=device,
        mesh=mesh,
        use_fused=config.rag.use_fused_topk,
        corpus_dtype=params.get("corpus_dtype", config.rag.corpus_dtype),
    )
    pipeline = QueryPipeline(embedder, retriever)
    return RAGEngine(
        pipeline=pipeline if pipeline.applicable() else None,
        retriever=retriever,
        embedder=embedder,
        reranker=reranker,
        modules=list(indexes.keys()),
        params={
            "reranker_top_n": top_n,
            "confidence_cutoff": params.get("confidence_cutoff", config.rag.default_confidence_threshold),
            "confidence_cutoff_hard": params.get(
                "confidence_cutoff_hard", config.rag.default_confidence_cutoff_hard
            ),
            "embedding_model": embedding_model,
            "reranker_model": reranker_model if use_reranker else None,
            **params,
        },
    )
