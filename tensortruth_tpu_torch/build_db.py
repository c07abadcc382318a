"""`tensor-truth-tpu-torch-build` CLI — offline index building.

Mirrors the reference build CLI surface (reference build_db.py:25-301):
module selection (--modules/--all/--books/--libraries/--papers), chunking
params, strategy, embedding model; validates modules against sources.json
and the docs directory before building.

Port of ``tensortruth_tpu/build_db.py``. It differs from it in two places
only:

* no ``enable_persistent_compilation_cache()`` at the top of ``main``:
  PyTorch runs eagerly and has no XLA cache to keep;
* the embedder comes from this package's ``ModelManager``, whose
  ``get_embedder(spec)`` without a device reuses the resident model
  wherever it is and otherwise loads it on ``cuda``. So the CLI builds on
  the card by default; a program that wants the CPU seats a CPU embedder in
  the manager first (``get_embedder(spec, device="cpu")``).
"""

from __future__ import annotations

import argparse
import logging
import sys

from tensortruth_tpu_torch.app.paths import (
    get_base_indexes_dir,
    get_library_docs_dir,
)
from tensortruth_tpu_torch.app.sources import (
    list_all_modules,
    load_user_sources,
)
from tensortruth_tpu_torch.index.chunker import DEFAULT_CHUNK_OVERLAP, DEFAULT_CHUNK_SIZES
from tensortruth_tpu_torch.indexing.builder import build_module
from tensortruth_tpu_torch.utils.validation import validate_module_for_build

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Build TPU vector indexes")
    sel = parser.add_mutually_exclusive_group(required=True)
    sel.add_argument("--modules", nargs="+", help="modules to build")
    sel.add_argument("--all", action="store_true", help="build every module")
    sel.add_argument("--books", action="store_true")
    sel.add_argument("--libraries", action="store_true")
    sel.add_argument("--papers", action="store_true")
    # None → the config's default_embedding_model (reference
    # build_db.py:174-205 resolves from config when the flag is absent;
    # hardcoding bge-m3 here built under the wrong model dir whenever the
    # deployment configured a different default)
    parser.add_argument("--embedding-model", default=None)
    parser.add_argument("--chunk-sizes", nargs="+", type=int, default=list(DEFAULT_CHUNK_SIZES))
    parser.add_argument("--chunk-overlap", type=int, default=DEFAULT_CHUNK_OVERLAP)
    parser.add_argument(
        "--chunking-strategy",
        choices=["hierarchical", "semantic", "semantic_hierarchical"],
        default="hierarchical",
    )
    parser.add_argument("--semantic-buffer-size", type=int, default=1)
    parser.add_argument("--semantic-breakpoint-threshold", type=float, default=95.0)
    parser.add_argument(
        "--extensions",
        nargs="+",
        default=None,
        help="file extensions to index (reference default: .md .html .pdf)",
    )
    # Path overrides: CLI flag > env var > default (reference
    # build_db.py:57-88 + cli_paths.py precedence)
    parser.add_argument("--library-docs-dir", default=None)
    parser.add_argument("--sources-config", default=None)
    parser.add_argument("--indexes-dir", default=None)
    parser.add_argument(
        "--no-validate",
        action="store_true",
        help="skip module/docs-dir validation (private or ad-hoc layouts)",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    sources = load_user_sources(args.sources_config)
    if args.all:
        modules = list_all_modules(sources)
    elif args.books:
        modules = list(sources.get("books", {}))
    elif args.libraries:
        modules = list(sources.get("libraries", {}))
    elif args.papers:
        modules = list(sources.get("papers", {}))
    else:
        modules = args.modules
    if not modules:
        logger.error("no modules selected")
        return 1

    from pathlib import Path

    docs_dir = Path(args.library_docs_dir) if args.library_docs_dir else get_library_docs_dir()
    if not args.no_validate:
        errors = {m: validate_module_for_build(m, sources, docs_dir) for m in modules}
        for m, err in errors.items():
            if err:
                logger.error("%s: %s", m, err)
        modules = [m for m in modules if not errors[m]]
        if not modules:
            return 1

    from tensortruth_tpu_torch.app.config import load_config
    from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec

    cfg = load_config()
    if args.embedding_model is None:
        args.embedding_model = cfg.rag.default_embedding_model
    mc = cfg.rag.get_embedding_model_config(args.embedding_model)
    embedder = ModelManager.get_instance().get_embedder(
        ModelSpec(
            args.embedding_model,
            dtype=mc.dtype,
            max_length=mc.max_length,
            local_dir=mc.local_dir,
            tokenizer_path=mc.tokenizer_path,
            batch_buckets=tuple(mc.batch_buckets) if mc.batch_buckets else None,
            seq_buckets=tuple(mc.seq_buckets) if mc.seq_buckets else None,
        )
    )

    indexes_dir = Path(args.indexes_dir) if args.indexes_dir else get_base_indexes_dir()
    ok = True
    for m in modules:
        ok &= build_module(
            m,
            embedder,
            library_docs_dir=docs_dir,
            indexes_dir=indexes_dir,
            sources=sources,
            embedding_model=args.embedding_model,
            chunk_sizes=args.chunk_sizes,
            chunk_overlap=args.chunk_overlap,
            chunking_strategy=args.chunking_strategy,
            semantic_buffer_size=args.semantic_buffer_size,
            semantic_breakpoint_threshold=args.semantic_breakpoint_threshold,
            extensions=args.extensions,
        )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
