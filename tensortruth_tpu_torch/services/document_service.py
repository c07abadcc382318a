"""Scope-based document ingestion: upload → convert → index.

Behavioral mirror of reference services/document_service.py:24-651 +
pdf_handler.py: session/project scopes, PDF/markdown/text/url/arXiv intake,
stable doc ids (``pdf_<hash>_<name>``), markdown persistence next to the
index, incremental reindex and delete. Network ingestion (URL/arXiv) is
gated on outbound access and surfaces a clear error offline.
"""

from __future__ import annotations

import hashlib
import logging
import os
import re
from pathlib import Path

from tensortruth_tpu_torch.services.document_index import DocumentIndexBuilder
from tensortruth_tpu_torch.utils.pdf import pdf_to_text, post_process_markdown

logger = logging.getLogger(__name__)


def make_doc_id(filename: str, data: bytes) -> str:
    """pdf_<hash>_<safe-name> (reference pdf_handler.py:16-80)."""
    digest = hashlib.sha256(data).hexdigest()[:10]
    safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", Path(filename).stem)[:60]
    return f"pdf_{digest}_{safe}"


class DocumentService:
    """One instance serves both scopes; scope dirs are passed per call."""

    def __init__(
        self,
        embedder_factory,
        chunk_sizes: list[int] | None = None,
        chunk_overlap: int = 64,
    ):
        """``embedder_factory() -> Embedder`` defers model loading until the
        first ingestion (reference loads lazily via ModelManager)."""
        self._embedder_factory = embedder_factory
        self.chunk_sizes = chunk_sizes
        self.chunk_overlap = chunk_overlap

    def _builder(self, scope_dir: Path) -> DocumentIndexBuilder:
        # Pass the FACTORY: the builder loads the model lazily, so pure
        # bookkeeping ops (delete/list) on a cold server skip the 568M load.
        return DocumentIndexBuilder(
            Path(scope_dir) / "index",
            self._embedder_factory,
            chunk_sizes=self.chunk_sizes,
            chunk_overlap=self.chunk_overlap,
        )

    # -- intake -------------------------------------------------------------------

    def add_pdf(
        self, scope_dir: str | Path, filename: str, data: bytes, metadata: dict | None = None
    ) -> dict:
        scope_dir = Path(scope_dir)
        doc_id = make_doc_id(filename, data)
        (scope_dir / "pdfs").mkdir(parents=True, exist_ok=True)
        pdf_path = scope_dir / "pdfs" / f"{doc_id}.pdf"
        pdf_path.write_bytes(data)
        text = post_process_markdown(pdf_to_text(data))
        if not text.strip():
            # nothing was indexed, so delete-document 404s for this id —
            # keeping the file would orphan it with no API path to remove
            pdf_path.unlink(missing_ok=True)
            return {
                "doc_id": doc_id,
                "status": "failed",
                "error": "no extractable text (scanned PDF?)",
            }
        return self._index_text(scope_dir, doc_id, text, filename, metadata)

    def add_text(
        self,
        scope_dir: str | Path,
        filename: str,
        text: str,
        metadata: dict | None = None,
    ) -> dict:
        doc_id = make_doc_id(filename, text.encode())
        return self._index_text(
            Path(scope_dir), doc_id, post_process_markdown(text), filename, metadata
        )

    def add_url(self, scope_dir: str | Path, url: str, metadata: dict | None = None) -> dict:
        """Fetch a page and index it (reference document_service URL path);
        requires outbound network."""
        try:
            from tensortruth_tpu_torch.web.fetch import fetch_url_as_markdown

            title, markdown = fetch_url_as_markdown(url)
        except Exception as e:
            return {"doc_id": None, "status": "failed", "error": f"fetch failed: {e}"}
        meta = {"source_url": url, "title": title, **(metadata or {})}
        return self.add_text(scope_dir, title or url, markdown, meta)

    def add_arxiv(self, scope_dir: str | Path, arxiv_id: str) -> dict:
        """Download an arXiv paper and index it (reference documents.py
        upload-arxiv / services/document_service.py arXiv intake)."""
        try:
            from tensortruth_tpu_torch.web.fetch import ArxivHandler

            title, md = ArxivHandler().fetch(f"https://arxiv.org/abs/{arxiv_id}")
        except Exception as e:
            return {"doc_id": None, "status": "failed", "error": f"arxiv fetch failed: {e}"}
        meta = {"arxiv_id": arxiv_id, "title": title}
        return self.add_text(scope_dir, f"{arxiv_id}.md", md, meta)

    def add_file_url(self, scope_dir: str | Path, url: str) -> dict:
        """Download a file (PDF or text) from a direct URL and index it
        (reference documents.py upload-file-url)."""
        try:
            import requests

            r = requests.get(url, timeout=60)
            r.raise_for_status()
        except Exception as e:
            return {"doc_id": None, "status": "failed", "error": f"download failed: {e}"}
        filename = url.rstrip("/").rsplit("/", 1)[-1] or "download"
        ctype = r.headers.get("Content-Type", "")
        if filename.lower().endswith(".pdf") or "pdf" in ctype:
            return self.add_pdf(scope_dir, filename, r.content, {"source_url": url})
        return self.add_text(
            scope_dir, filename, r.content.decode("utf-8", "ignore"), {"source_url": url}
        )

    def _index_text(
        self, scope_dir: Path, doc_id: str, text: str, filename: str, metadata: dict | None
    ) -> dict:
        md_dir = scope_dir / "markdown"
        md_dir.mkdir(parents=True, exist_ok=True)
        # tmp + rename: a crash mid-write must not leave a torn .md that a
        # later settings-change reindex would silently ingest truncated
        md_tmp = md_dir / f"{doc_id}.md.tmp-{os.getpid()}"
        md_tmp.write_text(text, encoding="utf-8")
        md_tmp.replace(md_dir / f"{doc_id}.md")
        meta = {"filename": filename, **(metadata or {})}
        builder = self._builder(scope_dir)
        n = builder.add_documents({doc_id: text}, {doc_id: meta})
        return {"doc_id": doc_id, "status": "success", "chunks": n}

    # -- management ------------------------------------------------------------------

    def list_documents(self, scope_dir: str | Path) -> list[str]:
        return self._builder(Path(scope_dir)).doc_ids()

    def describe_documents(self, scope_dir: str | Path) -> list[dict]:
        """[{id, filename, chunks}] for the management UI (reference
        PDFListResponse shape, api/routes/pdfs.py:15).

        Reads ONLY the node hierarchy file — never the embedding matrix and
        never the embedder (whose construction would load a 568M model just
        to list filenames on a cold server)."""
        from tensortruth_tpu_torch.index.nodes import HierarchyStore
        from tensortruth_tpu_torch.index.store import HIER_FILE

        hier = Path(scope_dir) / "index" / HIER_FILE
        if not hier.exists():
            return []
        store = HierarchyStore.load(hier)
        by_doc: dict[str, dict] = {}
        for n in store.nodes():
            d = by_doc.setdefault(
                n.doc_id,
                {"id": n.doc_id, "filename": "", "chunks": 0},
            )
            if not d["filename"]:
                d["filename"] = (n.metadata or {}).get("filename", "")
            if n.is_leaf:  # leaves = embedded chunks
                d["chunks"] += 1
        return [by_doc[k] for k in sorted(by_doc)]

    def remove_document(self, scope_dir: str | Path, doc_id: str) -> int:
        scope_dir = Path(scope_dir)
        removed = self._builder(scope_dir).remove_document(doc_id)
        for sub, ext in (("pdfs", ".pdf"), ("markdown", ".md")):
            p = scope_dir / sub / f"{doc_id}{ext}"
            if p.exists():
                p.unlink()
        return removed

    def _stored_metadata(self, scope_dir: Path) -> dict[str, dict]:
        """Per-document metadata harvested from the EXISTING index nodes.

        filename/source_url/arxiv_id live only in node metadata (written at
        ingest by ``_index_text``); a rebuild that reads just the markdown
        bodies would erase them permanently — blank names in the documents
        panel, dead source links."""
        from tensortruth_tpu_torch.index.nodes import HierarchyStore
        from tensortruth_tpu_torch.index.store import HIER_FILE

        hier = Path(scope_dir) / "index" / HIER_FILE
        if not hier.exists():
            return {}
        meta: dict[str, dict] = {}
        for n in HierarchyStore.load(hier).nodes():
            if n.doc_id not in meta and n.metadata:
                # doc_type is re-stamped by the chunker on rebuild
                meta[n.doc_id] = {
                    k: v for k, v in n.metadata.items() if k != "doc_type"
                }
        return meta

    def reindex(self, scope_dir: str | Path) -> int:
        """Full rebuild from stored markdown (reference reindex endpoint),
        carrying each document's ingest metadata forward."""
        scope_dir = Path(scope_dir)
        md_dir = scope_dir / "markdown"
        docs = {
            p.stem: p.read_text(encoding="utf-8")
            for p in sorted(md_dir.glob("*.md"))
        } if md_dir.exists() else {}
        if not docs:
            return 0
        metadata = self._stored_metadata(scope_dir)
        builder = self._builder(scope_dir)
        builder.build_index(docs, metadata)
        return len(docs)

    def index_path(self, scope_dir: str | Path) -> Path:
        return Path(scope_dir) / "index"

    def index_exists(self, scope_dir: str | Path) -> bool:
        # No _builder(): that would invoke the embedder factory (model load)
        # for a pure filesystem check.
        from tensortruth_tpu_torch.index.store import VectorIndex

        return VectorIndex.is_valid(self.index_path(scope_dir))

    def delete_index(self, scope_dir: str | Path) -> bool:
        """Drop the scope index so the next build starts fresh — the
        reference deletes the index when indexing settings change
        (documents.py:687-740 update_project_indexing_config)."""
        import shutil

        p = self.index_path(scope_dir)
        if not p.exists():
            return False
        shutil.rmtree(p)
        return True
