"""Per-session image storage + response image localization.

Mirrors reference services/image_service.py:1-213 + routes/chat.py:51-92:
uploaded/base64 images saved under ``sessions/{id}/images`` and served via
``/api/sessions/{id}/images/{image_id}``; external image URLs in responses
are downloaded and rewritten to local URLs.
"""

from __future__ import annotations

import base64
import hashlib
import logging
import re
from pathlib import Path

logger = logging.getLogger(__name__)

_EXT_BY_MAGIC = [(b"\x89PNG", ".png"), (b"\xff\xd8", ".jpg"), (b"GIF8", ".gif"),
                 (b"RIFF", ".webp")]
_MD_IMAGE_RE = re.compile(r"!\[([^\]]*)\]\((https?://[^)\s]+)\)")


def _ext_for(data: bytes) -> str:
    for magic, ext in _EXT_BY_MAGIC:
        if data.startswith(magic):
            return ext
    return ".bin"


class ImageService:
    def __init__(self, images_dir_fn=None):
        from tensortruth_tpu_torch.app.paths import get_session_images_dir

        self._dir_fn = images_dir_fn or get_session_images_dir

    def save_image(self, session_id: str, data: bytes) -> str:
        image_id = hashlib.sha256(data).hexdigest()[:16] + _ext_for(data)
        path = self._dir_fn(session_id) / image_id
        if not path.exists():
            path.write_bytes(data)
        return image_id

    def save_base64(self, session_id: str, b64: str) -> str:
        if "," in b64:  # data: URI prefix
            b64 = b64.split(",", 1)[1]
        return self.save_image(session_id, base64.b64decode(b64))

    def get_path(self, session_id: str, image_id: str) -> Path | None:
        p = self._dir_fn(session_id) / image_id
        return p if p.exists() else None

    def localize_response_images(self, session_id: str, markdown: str) -> str:
        """Download external images referenced in a response and rewrite to
        local URLs (reference chat.py:51-92); failures leave the URL as-is."""
        import requests

        def repl(m: re.Match) -> str:
            alt, url = m.group(1), m.group(2)
            try:
                r = requests.get(url, timeout=15)
                r.raise_for_status()
                image_id = self.save_image(session_id, r.content)
                return f"![{alt}](/api/sessions/{session_id}/images/{image_id})"
            except Exception as e:
                logger.debug("image localization failed for %s: %s", url, e)
                return m.group(0)

        return _MD_IMAGE_RE.sub(repl, markdown)
