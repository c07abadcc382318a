"""PDF utilities: text extraction, page splitting, math normalization.

Covers the contracts of reference utils/pdf.py:23-658 that matter to the
engine (extractable-text probe, page-chunk splitting, math-delimiter
normalization, invalid-character scrubbing). The reference converts PDFs via
PyMuPDF/marker (C/CUDA deps unavailable in this environment); here a backend
ladder is used:

1. ``pymupdf`` when importable (same quality as the reference),
2. a dependency-free fallback extractor: parses xref-less PDFs by scanning
   COS objects, zlib-inflating content streams and pulling text from
   Tj/TJ/' operators — good enough for digitally-born PDFs, returns "" for
   scanned ones (matching the reference's extractable-text probe semantics).
"""

from __future__ import annotations

import logging
import re
import zlib

logger = logging.getLogger(__name__)

# -- backend ladder ------------------------------------------------------------


def _require_importable(*modules: str, hint: str) -> None:
    """Raise ImportError only when a module is truly missing — an explicit
    converter choice must distinguish 'dependency absent' from 'dependency
    present but the PDF failed to extract', or the operator chases a
    nonexistent install problem."""
    import importlib.util

    for mod in modules:
        if importlib.util.find_spec(mod) is None:
            raise ImportError(
                f"explicit converter dependency {mod!r} is not importable ({hint})"
            )


def _extract_with_pymupdf(data: bytes) -> list[str] | None:
    """None on ANY failure (not just missing pymupdf): pymupdf is stricter
    than the pure-python fallback, and a malformed/encrypted PDF it rejects
    may still yield text below — never abort ingestion here."""
    try:
        import pymupdf  # type: ignore

        with pymupdf.open(stream=data, filetype="pdf") as doc:
            return [page.get_text() for page in doc]
    except ImportError:
        return None
    except Exception as e:  # noqa: BLE001 — fall back to the COS parser
        logger.debug("pymupdf extraction failed, using fallback: %s", e)
        return None


_STREAM_RE = re.compile(rb"stream\r?\n(.*?)endstream", re.DOTALL)
# Text-showing operators inside content streams: (..) Tj, (..) ', [..] TJ
_TJ_RE = re.compile(rb"\((?:\\.|[^\\()])*\)\s*(?:Tj|')|\[(?:\\.|[^\]])*\]\s*TJ")
_PSTR_RE = re.compile(rb"\((?:\\.|[^\\()])*\)")
_PAGE_RE = re.compile(rb"/Type\s*/Page[^s]")

_ESCAPES = {
    b"\\n": b"\n", b"\\r": b"\r", b"\\t": b"\t",
    b"\\(": b"(", b"\\)": b")", b"\\\\": b"\\",
}


def _decode_pdf_string(raw: bytes) -> str:
    body = raw[1:-1]
    for esc, rep in _ESCAPES.items():
        body = body.replace(esc, rep)
    body = re.sub(rb"\\(\d{1,3})", lambda m: bytes([int(m.group(1), 8) & 0xFF]), body)
    if body.startswith(b"\xfe\xff"):  # UTF-16BE text string
        try:
            return body[2:].decode("utf-16-be", errors="ignore")
        except Exception:
            return ""
    return body.decode("latin-1", errors="ignore")


# -- pure-python COS object model (no pymupdf) ----------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+\d+\s+obj\b(.*?)endobj", re.DOTALL)
_REF_RE = re.compile(rb"(\d+)\s+\d+\s+R\b")
# Text layout operators inside BT..ET: strings, arrays, line moves.
_TEXTOP_RE = re.compile(
    rb"\[(?:\((?:\\.|[^\\()])*\)|[^\]])*\]\s*TJ"  # [..] TJ
    rb"|\((?:\\.|[^\\()])*\)\s*(?:Tj|')"  # (..) Tj / (..) '
    rb"|T\*"  # next line
    rb"|-?[0-9.]+[ \t]+-?[0-9.]+[ \t]+T[dD]"  # Td/TD moves
)
_TJ_SPACE_THRESHOLD = -180  # thousandths of an em: bigger gaps become spaces


def _parse_objects(data: bytes) -> dict[int, bytes]:
    """obj number → body bytes for classic (non-object-stream) PDFs."""
    return {int(m.group(1)): m.group(2) for m in _OBJ_RE.finditer(data)}


def _dict_value(body: bytes, key: bytes) -> bytes | None:
    """Raw value after /key in a COS dictionary body (first occurrence)."""
    m = re.search(rb"/" + key + rb"\s*", body)
    if not m:
        return None
    rest = body[m.end():]
    if rest.startswith(b"["):  # array: match to balanced close
        depth = 0
        for i, ch in enumerate(rest):
            if ch == 0x5B:
                depth += 1
            elif ch == 0x5D:
                depth -= 1
                if depth == 0:
                    return rest[: i + 1]
        return None
    m2 = re.match(rb"(\d+\s+\d+\s+R|/[^\s/\[\]<>]+|\((?:\\.|[^\\()])*\)|<[^>]*>|[^\s/\[\]<>]+)", rest)
    return m2.group(0) if m2 else None


def _first_ref(raw: bytes | None) -> int | None:
    if raw is None:
        return None
    m = _REF_RE.search(raw)
    return int(m.group(1)) if m else None


def _ordered_page_objnums(objs: dict[int, bytes]) -> list[int]:
    """Walk the /Pages tree in /Kids order → page object numbers."""
    root = None
    for num, body in objs.items():
        if re.search(rb"/Type\s*/Catalog\b", body):
            root = _first_ref(_dict_value(body, b"Pages"))
            break
    if root is None:
        return []
    out: list[int] = []

    def walk(num: int, depth=0):
        if depth > 64 or num not in objs:
            return
        body = objs[num]
        if re.search(rb"/Type\s*/Page\b", body) and not re.search(
            rb"/Type\s*/Pages\b", body
        ):
            out.append(num)
            return
        kids = _dict_value(body, b"Kids")
        if kids:
            for m in _REF_RE.finditer(kids):
                walk(int(m.group(1)), depth + 1)

    walk(root)
    return out


def _content_streams(objs: dict[int, bytes], page_num: int) -> list[bytes]:
    refs = _dict_value(objs.get(page_num, b""), b"Contents")
    streams = []
    if refs:
        for m in _REF_RE.finditer(refs):
            body = objs.get(int(m.group(1)), b"")
            sm = _STREAM_RE.search(body)
            if sm:
                streams.append(sm.group(1))
    return streams


def _stream_text(content: bytes) -> str:
    """Decode one content stream's text operators with layout heuristics:
    Td/TD/T*/' start new lines; large negative TJ kerns become spaces."""
    try:
        content = zlib.decompress(content)
    except zlib.error:
        pass
    parts: list[str] = []
    for m in _TEXTOP_RE.finditer(content):
        op = m.group(0)
        if op.endswith(b"TJ"):
            for piece in re.finditer(
                rb"\((?:\\.|[^\\()])*\)|-?[0-9.]+", op
            ):
                tok = piece.group(0)
                if tok.startswith(b"("):
                    parts.append(_decode_pdf_string(tok))
                else:
                    try:
                        if float(tok) <= _TJ_SPACE_THRESHOLD:
                            parts.append(" ")
                    except ValueError:
                        pass
        elif op.endswith(b"Tj"):
            s = _PSTR_RE.search(op)
            if s:
                parts.append(_decode_pdf_string(s.group(0)))
        elif op.endswith(b"'"):
            s = _PSTR_RE.search(op)
            parts.append("\n")
            if s:
                parts.append(_decode_pdf_string(s.group(0)))
        else:  # T*, Td, TD — line move
            parts.append("\n")
    return "".join(parts)


def _extract_fallback(data: bytes) -> list[str]:
    """Page-aware extraction via the /Pages tree; stream-scan as last resort."""
    objs = _parse_objects(data)
    page_nums = _ordered_page_objnums(objs)
    if page_nums:
        pages = []
        for pn in page_nums:
            text = "".join(_stream_text(s) for s in _content_streams(objs, pn))
            pages.append(text)
        if any(p.strip() for p in pages):
            return pages
    # xref-stream/object-stream PDFs: fall back to scanning all streams.
    pages = []
    for m in _STREAM_RE.finditer(data):
        text = _stream_text(m.group(1))
        if text.strip():
            pages.append(text)
    return pages


# Converter quality tiers (reference utils/pdf.py:356-467 + fetch_sources
# converter flag): "marker" (layout-model markdown, heaviest, whole-doc
# only), "pymupdf4llm" (structured markdown, per-page capable), "pymupdf"
# (plain text per page), "fallback" (pure-python COS parser, always
# available). "auto" = best per-page-capable converter present.
CONVERTERS = ("auto", "marker", "pymupdf4llm", "pymupdf", "fallback")


def _extract_with_pymupdf4llm(data: bytes) -> list[str] | None:
    """Per-page markdown via pymupdf4llm; None when unavailable/failed."""
    try:
        import pymupdf  # type: ignore
        import pymupdf4llm  # type: ignore

        with pymupdf.open(stream=data, filetype="pdf") as doc:
            chunks = pymupdf4llm.to_markdown(doc, page_chunks=True)
        return [c.get("text", "") for c in chunks]
    except ImportError:
        return None
    except Exception as e:
        logger.debug("pymupdf4llm extraction failed: %s", e)
        return None


def _convert_with_marker(data: bytes) -> str:
    """Whole-document markdown via marker-pdf (layout/OCR models).
    Raises ImportError when marker is not installed."""
    import tempfile

    from marker.converters.pdf import PdfConverter  # type: ignore
    from marker.models import create_model_dict  # type: ignore
    from marker.output import text_from_rendered  # type: ignore

    with tempfile.NamedTemporaryFile(suffix=".pdf") as f:
        f.write(data)
        f.flush()
        converter = PdfConverter(artifact_dict=create_model_dict())
        rendered = converter(f.name)
        text, _, _ = text_from_rendered(rendered)
        return text


def extract_pdf_pages(data: bytes, converter: str = "auto") -> list[str]:
    """Per-page text; empty list when nothing extractable.

    ``converter`` picks the quality tier (CONVERTERS). An EXPLICIT choice
    whose dependency is missing raises ImportError — a silent downgrade
    would quietly degrade a whole book build; ``auto`` ladders
    pymupdf4llm → pymupdf → pure-python fallback. "marker" has no page
    mapping (whole-doc model) — use it via ``pdf_to_text``/arxiv paths;
    here it downgrades to pymupdf with a warning.
    """
    if converter not in CONVERTERS:
        raise ValueError(f"unknown converter {converter!r}; pick from {CONVERTERS}")
    if converter == "fallback":
        return _extract_fallback(data)
    if converter == "marker":
        logger.warning(
            "marker has no per-page mapping; using pymupdf for page split"
        )
        converter = "pymupdf"
    if converter == "pymupdf4llm":
        pages = _extract_with_pymupdf4llm(data)
        if pages is None:
            _require_importable("pymupdf4llm", "pymupdf",
                                hint="pip install pymupdf4llm")
            raise ValueError(
                "converter 'pymupdf4llm' is installed but failed to extract "
                "this PDF (corrupt or encrypted input?)"
            )
        return pages
    if converter == "pymupdf":
        pages = _extract_with_pymupdf(data)
        if pages is None:
            _require_importable("pymupdf", hint="pip install pymupdf")
            raise ValueError(
                "converter 'pymupdf' is installed but failed to extract "
                "this PDF (corrupt or encrypted input?)"
            )
        return pages
    # auto: best per-page converter available, degrading silently
    pages = _extract_with_pymupdf4llm(data)
    if pages is None:
        pages = _extract_with_pymupdf(data)
    if pages is None:
        pages = _extract_fallback(data)
    return pages


# -- TOC / outline extraction (reference scrapers/book.py:109-298) --------------


def extract_pdf_toc(data: bytes) -> list[dict]:
    """[{level, title, page}] from the PDF outline tree (0-based pages).

    pymupdf's get_toc() when available; otherwise a pure-python walk of
    /Outlines → /First../Next chains, resolving /Dest or /A<</D ..>>
    destinations against the page tree order.
    """
    try:
        import pymupdf  # type: ignore

        with pymupdf.open(stream=data, filetype="pdf") as doc:
            return [
                {"level": lvl, "title": title, "page": max(0, page - 1)}
                for lvl, title, page in doc.get_toc()
            ]
    except ImportError:
        pass
    except Exception as e:  # noqa: BLE001 — pure-python outline walk below
        logger.debug("pymupdf TOC failed, using fallback: %s", e)

    objs = _parse_objects(data)
    page_order = {pn: i for i, pn in enumerate(_ordered_page_objnums(objs))}
    outlines_ref = None
    for body in objs.values():
        if re.search(rb"/Type\s*/Catalog\b", body):
            outlines_ref = _first_ref(_dict_value(body, b"Outlines"))
            break
    if outlines_ref is None or outlines_ref not in objs:
        return []

    def dest_page(body: bytes) -> int | None:
        dest = _dict_value(body, b"Dest")
        if dest is None:
            a_ref = _first_ref(_dict_value(body, b"A"))
            action = objs.get(a_ref, b"") if a_ref else b""
            if not action:  # inline action dictionary
                m = re.search(rb"/A\s*<<(.*?)>>", body, re.DOTALL)
                action = m.group(1) if m else b""
            dest = _dict_value(action, b"D")
        ref = _first_ref(dest)
        return page_order.get(ref) if ref is not None else None

    out: list[dict] = []

    def walk(num: int, level: int, guard: set):
        while num and num in objs and num not in guard:
            guard.add(num)
            body = objs[num]
            title_raw = _dict_value(body, b"Title")
            title = (
                _decode_pdf_string(title_raw)
                if title_raw and title_raw.startswith(b"(")
                else (title_raw or b"").decode("latin-1", "ignore")
            )
            page = dest_page(body)
            if title.strip() and page is not None:
                out.append({"level": level, "title": title.strip(), "page": page})
            first = _first_ref(_dict_value(body, b"First"))
            if first:
                walk(first, level + 1, guard)
            num = _first_ref(_dict_value(body, b"Next"))

    walk(_first_ref(_dict_value(objs[outlines_ref], b"First")) or 0, 1, set())
    return out


def split_pages_by_toc(
    pages: list[str],
    toc: list[dict],
    max_pages_per_chapter: int | None = None,
) -> list[tuple[str, str]]:
    """(chapter_title, text) splits at top-level TOC entries
    (reference scrapers/book.py:109-298). Chapters longer than
    ``max_pages_per_chapter`` re-chunk into '<title> (part N)' pieces."""
    tops = [t for t in toc if t["level"] == 1 and 0 <= t["page"] < len(pages)]
    if len(tops) < 2:
        return []
    tops.sort(key=lambda t: t["page"])
    out: list[tuple[str, str]] = []
    if tops[0]["page"] > 0:  # front matter before the first chapter
        out.append(("Front Matter", "\n\n".join(pages[: tops[0]["page"]])))
    for i, entry in enumerate(tops):
        start = entry["page"]
        end = tops[i + 1]["page"] if i + 1 < len(tops) else len(pages)
        span = pages[start:end]
        if max_pages_per_chapter and len(span) > max_pages_per_chapter:
            for j in range(0, len(span), max_pages_per_chapter):
                part = span[j : j + max_pages_per_chapter]
                n = j // max_pages_per_chapter + 1
                out.append((f"{entry['title']} (part {n})", "\n\n".join(part)))
        else:
            out.append((entry["title"], "\n\n".join(span)))
    return out


def pdf_to_text(data: bytes, converter: str = "auto") -> str:
    """Whole-document text/markdown with converter choice (CONVERTERS).
    "marker" converts the whole document through the layout model; others
    join the per-page extraction."""
    if converter == "marker":
        return _convert_with_marker(data)
    return "\n\n".join(extract_pdf_pages(data, converter=converter))


def has_extractable_text(data: bytes, min_chars: int = 100) -> bool:
    """Extractable-text probe (reference utils/pdf.py extractable check)."""
    return len(pdf_to_text(data).strip()) >= min_chars


def split_pages_into_chunks(pages: list[str], pages_per_chunk: int = 15) -> list[str]:
    """Fixed page chunks, default 15 (reference scrapers/book.py:299)."""
    return [
        "\n\n".join(pages[i : i + pages_per_chunk])
        for i in range(0, len(pages), pages_per_chunk)
    ]


def extract_pdf_metadata(data: bytes) -> dict:
    """{title, authors} from the document Info dictionary
    (reference utils/pdf.py PDF-embedded metadata extraction). pymupdf when
    available, else the pure-python COS parser reads /Info's /Title and
    /Author entries."""
    try:
        import pymupdf  # type: ignore

        with pymupdf.open(stream=data, filetype="pdf") as doc:
            md = doc.metadata or {}
            authors = [a.strip() for a in (md.get("author") or "").split(";") if a.strip()]
            return {"title": (md.get("title") or "").strip(), "authors": authors}
    except ImportError:
        pass
    except Exception as e:  # noqa: BLE001 — COS /Info parse below
        logger.debug("pymupdf metadata failed, using fallback: %s", e)
    objs = _parse_objects(data)
    info_ref = None
    m = re.search(rb"trailer\s*<<(.*?)>>", data, re.DOTALL)
    if m:
        info_ref = _first_ref(_dict_value(m.group(1), b"Info"))
    candidates = [objs[info_ref]] if info_ref in objs else []
    if not candidates:  # some writers omit the trailer ref; scan for Info-ish dicts
        candidates = [
            b for b in objs.values()
            if b"/Title" in b and b"/Type" not in b and b"stream" not in b
        ]
    for body in candidates:
        title_raw = _dict_value(body, b"Title")
        author_raw = _dict_value(body, b"Author")
        title = _decode_pdf_string(title_raw) if title_raw and title_raw.startswith(b"(") else ""
        author = _decode_pdf_string(author_raw) if author_raw and author_raw.startswith(b"(") else ""
        if title or author:
            authors = [a.strip() for a in re.split(r"[;,]| and ", author) if a.strip()]
            return {"title": title.strip(), "authors": authors}
    return {"title": "", "authors": []}


def generate_book_name(title: str, fallback: str = "book") -> str:
    """Slug for sources.json keys / directory names (reference utils/pdf.py)."""
    slug = re.sub(r"[^a-z0-9]+", "_", title.lower()).strip("_")
    slug = re.sub(r"_+", "_", slug)[:60].strip("_")
    return slug or fallback


# -- math delimiter normalization (reference utils/pdf.py:469-520) -------------

_DISPLAY_RE = re.compile(r"\\\[(.+?)\\\]", re.DOTALL)
_INLINE_RE = re.compile(r"\\\((.+?)\\\)", re.DOTALL)


def normalize_math_delimiters(text: str) -> str:
    r"""``\[...\]`` → ``$$...$$`` and ``\(...\)`` → ``$...$`` so markdown
    renderers and the chunker see one canonical math syntax."""
    text = _DISPLAY_RE.sub(lambda m: f"$${m.group(1)}$$", text)
    text = _INLINE_RE.sub(lambda m: f"${m.group(1)}$", text)
    return text


_INVALID_RE = re.compile("[\x00-\x08\x0b\x0c\x0e-\x1f\ufffe\uffff\ud800-\udfff]")


def scrub_invalid_chars(text: str) -> str:
    """Strip control/surrogate characters that break JSON/sqlite persistence
    (reference scripts/check_invalid_characters.py contract)."""
    return _INVALID_RE.sub("", text)


def post_process_markdown(text: str) -> str:
    return scrub_invalid_chars(normalize_math_delimiters(text))
