"""arXiv paper fetching (reference scrapers/arxiv.py:14-139)."""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger(__name__)


def fetch_arxiv_paper(
    arxiv_id: str, output_dir: str | Path, converter: str | None = None
) -> bool:
    """Download a paper PDF by id and convert to markdown."""
    import requests

    from tensortruth_tpu_torch.utils.pdf import pdf_to_text, post_process_markdown

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    url = f"https://arxiv.org/pdf/{arxiv_id}"
    try:
        r = requests.get(url, timeout=60, headers={"User-Agent": "Mozilla/5.0"})
        r.raise_for_status()
    except Exception as e:
        logger.error("download failed for %s: %s", arxiv_id, e)
        return False
    text = post_process_markdown(pdf_to_text(r.content, converter=converter or "auto"))
    if not text.strip():
        logger.error("no extractable text in %s", arxiv_id)
        return False
    out = output_dir / f"{arxiv_id.replace('.', '_')}.md"
    out.write_text(text, encoding="utf-8")
    logger.info("saved %s (%d chars)", out, len(text))
    return True


def fetch_paper_category(
    category: str, config: dict, output_base_dir: str | Path,
    converter: str | None = None,
) -> bool:
    """Fetch every paper in a sources.json category
    (reference arxiv.py:85-139)."""
    papers = config.get("papers", config)
    converter = converter or config.get("converter")
    output_dir = Path(output_base_dir) / f"papers_{category}"
    ok = 0
    ids = list(papers.keys()) if isinstance(papers, dict) else list(papers)
    for arxiv_id in ids:
        if fetch_arxiv_paper(str(arxiv_id), output_dir, converter=converter):
            ok += 1
    return ok > 0
