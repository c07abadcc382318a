"""Dependency-free HTML → Markdown conversion built on BeautifulSoup.

Replaces the reference's html→markdown path
(reference utils/web_search.py:699-903 ``clean_html_for_content`` +
``fetch_generic_html``): strips nav/script/style/footer noise, preserves
headings, code blocks, lists, links, tables and content images.
"""

from __future__ import annotations

import re

NOISE_TAGS = [
    "script", "style", "nav", "footer", "header", "aside", "form",
    "noscript", "iframe", "svg", "button",
]
NOISE_CLASSES = re.compile(
    r"(sidebar|cookie|banner|advert|promo|popup|subscribe|newsletter)", re.I
)


def html_to_markdown(html: str, base_url: str = "") -> str:
    from bs4 import BeautifulSoup, NavigableString, Tag

    soup = BeautifulSoup(html, "html.parser")
    for tag in soup(NOISE_TAGS):
        tag.decompose()
    for tag in soup.find_all(class_=NOISE_CLASSES):
        tag.decompose()
    body = soup.find("main") or soup.find("article") or soup.body or soup

    def render(node, depth=0) -> str:
        if isinstance(node, NavigableString):
            return re.sub(r"\s+", " ", str(node))
        if not isinstance(node, Tag):
            return ""
        name = node.name
        inner = lambda: "".join(render(c, depth) for c in node.children)
        if name in ("h1", "h2", "h3", "h4", "h5", "h6"):
            return f"\n\n{'#' * int(name[1])} {inner().strip()}\n\n"
        if name == "p":
            return f"\n\n{inner().strip()}\n\n"
        if name == "br":
            return "\n"
        if name in ("strong", "b"):
            return f"**{inner().strip()}**"
        if name in ("em", "i"):
            return f"*{inner().strip()}*"
        if name == "code":
            return f"`{node.get_text()}`" if node.parent.name != "pre" else node.get_text()
        if name == "pre":
            return f"\n\n```\n{node.get_text().rstrip()}\n```\n\n"
        if name == "a":
            href = node.get("href", "")
            text = inner().strip() or href
            if href.startswith("/") and base_url:
                href = base_url.rstrip("/") + href
            return f"[{text}]({href})" if href else text
        if name == "img":
            src = node.get("src", "")
            if src.startswith("/") and base_url:
                src = base_url.rstrip("/") + src
            return f"![{node.get('alt', '')}]({src})" if src else ""
        if name in ("ul", "ol"):
            items = []
            for i, li in enumerate(node.find_all("li", recursive=False)):
                bullet = "-" if name == "ul" else f"{i + 1}."
                text = render_children_of(li, depth + 1).strip()
                items.append("  " * depth + f"{bullet} {text}")
            return "\n" + "\n".join(items) + "\n"
        if name == "blockquote":
            quoted = inner().strip().replace("\n", "\n> ")
            return f"\n\n> {quoted}\n\n"
        if name == "table":
            return _render_table(node)
        if name in ("td", "th", "tr", "thead", "tbody"):
            return inner()
        return inner()

    def render_children_of(tag, depth):
        return "".join(render(c, depth) for c in tag.children)

    def _render_table(table) -> str:
        rows = []
        for tr in table.find_all("tr"):
            cells = [
                re.sub(r"\s+", " ", td.get_text()).strip()
                for td in tr.find_all(["td", "th"])
            ]
            rows.append("| " + " | ".join(cells) + " |")
        if not rows:
            return ""
        sep = "| " + " | ".join("---" for _ in rows[0].split("|")[1:-1]) + " |"
        return "\n\n" + "\n".join([rows[0], sep] + rows[1:]) + "\n\n"

    text = render(body)
    text = re.sub(r"[ \t]+\n", "\n", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip()


def extract_title(html: str) -> str:
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(html, "html.parser")
    if soup.title and soup.title.string:
        return soup.title.string.strip()
    h1 = soup.find("h1")
    return h1.get_text().strip() if h1 else ""
