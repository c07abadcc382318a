"""Sphinx inventory scraping.

Mirrors reference scrapers/sphinx.py:11-45 (py-domain
function/class/method/module/data page URLs from ``objects.inv``). The
``sphobjinv`` wheel is unavailable here, so the inventory v2 format is
parsed directly: 4 header lines + zlib-compressed
``name domain:role priority uri dispname`` records.
"""

from __future__ import annotations

import logging
import posixpath
import zlib

logger = logging.getLogger(__name__)

WANTED_ROLES = {"function", "class", "method", "module", "data"}


def parse_inventory_v2(data: bytes) -> list[dict]:
    """objects.inv bytes → [{name, domain, role, uri}]."""
    lines = data.split(b"\n", 4)
    if not lines[0].startswith(b"# Sphinx inventory version 2"):
        raise ValueError("not a Sphinx inventory v2 file")
    payload = zlib.decompress(lines[4])
    out = []
    for line in payload.decode("utf-8", "ignore").splitlines():
        parts = line.split(" ", 4)
        if len(parts) < 5:
            continue
        name, domain_role, _priority, uri, dispname = parts
        if ":" not in domain_role:
            continue
        domain, role = domain_role.split(":", 1)
        # '$' suffix in uri means "replace with object name" (inv spec).
        if uri.endswith("$"):
            uri = uri[:-1] + name
        out.append({"name": name, "domain": domain, "role": role, "uri": uri})
    return out


def fetch_inventory(config: dict) -> list[str]:
    """Unique py-domain API page URLs (reference sphinx.py:11-45)."""
    import requests

    inventory_url = config["inventory_url"]
    logger.info("fetching inventory %s", inventory_url)
    try:
        r = requests.get(inventory_url, timeout=30)
        r.raise_for_status()
        objects = parse_inventory_v2(r.content)
    except Exception as e:
        logger.error("failed to fetch inventory: %s", e)
        return []
    doc_root = config.get("doc_root") or posixpath.dirname(inventory_url) + "/"
    urls = {
        posixpath.join(doc_root, obj["uri"]).split("#")[0]
        for obj in objects
        if obj["domain"] == "py" and obj["role"] in WANTED_ROLES
    }
    logger.info("found %d unique API pages", len(urls))
    return sorted(urls)
