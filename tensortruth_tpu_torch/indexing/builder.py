"""Offline module build: load docs → metadata → chunk → embed → persist.

TPU-native re-design of the reference's ``build_module``
(reference indexing/builder.py:251-457). Same pipeline contract — documents
from ``library_docs/{doc_type}_{module}/``, per-type metadata injection,
three chunking strategies, ALL nodes persisted / only leaves embedded, old
index removed before rebuild, ``index_metadata.json`` stamped — but the
persistence target is a VectorIndex directory (embeddings.npy + hierarchy
store, index/store.py) instead of Chroma+docstore, and embedding runs as
bucketed jit batches on the TPU (models/embedder.py) instead of
sentence-transformers loops.
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import Callable

from tensortruth_tpu_torch.app.sources import (
    get_document_type_for_module,
    load_user_sources,
    module_docs_dirname,
)
from tensortruth_tpu_torch.index.chunker import (
    DEFAULT_CHUNK_OVERLAP,
    DEFAULT_CHUNK_SIZES,
    ChunkingStrategy,
    chunk_document,
)
from tensortruth_tpu_torch.index.nodes import Node
from tensortruth_tpu_torch.index.store import VectorIndex
from tensortruth_tpu_torch.indexing.metadata import extract_metadata

logger = logging.getLogger(__name__)

SUPPORTED_EXTENSIONS = {".md", ".markdown", ".txt", ".html", ".htm", ".rst"}


def load_documents(
    docs_dir: str | Path, extensions: list[str] | None = None
) -> list[tuple[str, str]]:
    """(filename, text) pairs from a module docs dir (recursive), sorted for
    deterministic row order (replaces SimpleDirectoryReader,
    reference builder.py:339-344). ``extensions`` restricts the file set
    (reference build CLI --extensions, default [.md, .html, .pdf]); ``.pdf``
    entries are text-extracted via utils/pdf."""
    docs_dir = Path(docs_dir)
    allowed = (
        {e.lower() if e.startswith(".") else f".{e.lower()}" for e in extensions}
        if extensions
        else SUPPORTED_EXTENSIONS
    )
    out = []
    for p in sorted(docs_dir.rglob("*")):
        if not (p.is_file() and p.suffix.lower() in allowed):
            continue
        if p.suffix.lower() == ".pdf":
            from tensortruth_tpu_torch.utils.pdf import pdf_to_text, post_process_markdown

            try:
                text = post_process_markdown(pdf_to_text(p.read_bytes()))
            except Exception as e:  # noqa: BLE001 — skip one bad PDF, keep building
                logger.warning("skipping unparseable pdf %s: %s", p, e)
                continue
            if text.strip():
                out.append((str(p.relative_to(docs_dir)), text))
            continue
        try:
            out.append((str(p.relative_to(docs_dir)), p.read_text(encoding="utf-8")))
        except UnicodeDecodeError:
            logger.warning("skipping non-utf8 file %s", p)
    return out


def build_module(
    module_name: str,
    embedder,
    *,
    library_docs_dir: str | Path,
    indexes_dir: str | Path,
    sources: dict | None = None,
    embedding_model: str = "BAAI/bge-m3",
    chunk_sizes: list[int] | None = None,
    chunk_overlap: int = DEFAULT_CHUNK_OVERLAP,
    chunking_strategy: str = ChunkingStrategy.HIERARCHICAL.value,
    semantic_buffer_size: int = 1,
    semantic_breakpoint_threshold: float = 95.0,
    extensions: list[str] | None = None,
    progress_callback: Callable[[str, int, int], None] | None = None,
) -> bool:
    """Build one module's VectorIndex. Returns True on success.

    ``embedder`` needs ``encode(texts) -> (N, D) normalized`` and a
    ``tokenizer`` attribute (models/embedder.py contract).
    """
    from tensortruth_tpu_torch.index.store import sanitize_model_id

    chunk_sizes = chunk_sizes or list(DEFAULT_CHUNK_SIZES)
    sources = sources if sources is not None else load_user_sources()
    doc_type = get_document_type_for_module(sources, module_name)

    docs_dir = Path(library_docs_dir) / module_docs_dirname(doc_type, module_name)
    if not docs_dir.exists():
        logger.error("docs dir missing: %s", docs_dir)
        return False
    documents = load_documents(docs_dir, extensions)
    if not documents:
        logger.error("no documents in %s", docs_dir)
        return False
    logger.info("module %s: %d documents", module_name, len(documents))

    # Old index rm-rf'd before rebuild (reference builder.py:333-335).
    index_dir = (
        Path(indexes_dir)
        / sanitize_model_id(embedding_model)
        / f"{doc_type.value}_{module_name}"
    )
    if index_dir.exists():
        shutil.rmtree(index_dir)

    embed_fn = lambda texts: embedder.encode(texts)
    all_nodes: list[Node] = []
    for i, (fname, text) in enumerate(documents):
        if progress_callback:
            progress_callback("chunking", i, len(documents))
        meta = extract_metadata(text, fname, module_name, doc_type, sources)
        nodes = chunk_document(
            text,
            embedder.tokenizer,
            doc_id=fname,
            strategy=chunking_strategy,
            embed_fn=embed_fn,
            module=module_name,
            metadata=meta,
            **(
                dict(chunk_sizes=chunk_sizes, chunk_overlap=chunk_overlap)
                if chunking_strategy != ChunkingStrategy.SEMANTIC.value
                else {}
            ),
            **(
                dict(
                    buffer_size=semantic_buffer_size,
                    breakpoint_percentile=semantic_breakpoint_threshold,
                )
                if chunking_strategy != ChunkingStrategy.HIERARCHICAL.value
                else {}
            ),
        )
        all_nodes.extend(nodes)

    if progress_callback:
        progress_callback("embedding", 0, len(all_nodes))
    index = VectorIndex.build(
        all_nodes,
        embed_fn,
        embedding_model=embedding_model,
        chunk_sizes=chunk_sizes,
        chunk_overlap=chunk_overlap,
        chunking_strategy=chunking_strategy,
        gelu_flavor=getattr(embedder, "gelu_flavor", ""),
    )
    index.save(index_dir)
    if progress_callback:
        progress_callback("done", len(all_nodes), len(all_nodes))
    logger.info(
        "module %s built: %d nodes (%d leaves) -> %s",
        module_name, len(index.store), index.n_alive, index_dir,
    )
    return True
