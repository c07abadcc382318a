"""ctypes binding for the C++ host tokenizer (hostkit.cpp).

Build model: compile-on-first-use with the system ``g++`` into a per-user
cache directory keyed by a source hash, so editing hostkit.cpp invalidates
the cached .so automatically and installs never ship binaries. pybind11 is
deliberately not used (not in this environment); the ABI is a flat C
surface over caller-allocated numpy buffers, so ctypes adds no per-batch
overhead beyond the two array pointer casts.

Thread-safety: the returned :class:`HostKit` is stateless across calls
(the token cache in C++ is per-call), so one process-wide instance is
shared freely — matching how ``Reranker.score_pairs`` is called from the
batcher's worker thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).with_name("hostkit.cpp")
_LOCK = threading.Lock()
_HOSTKIT = None
_TRIED = False


def _unicode_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-BMP-codepoint tables the C tokenizer runs on, generated from the
    host Python's OWN `re` word/space classes and str.lower() so native
    parity holds by construction (no Unicode knowledge lives in C):

    * cls:  0 other (single-char token), 1 word (\\w), 2 space (\\s),
            3 fallback — surrogates, codepoints whose lowercase needs >2
            chars or leaves the BMP, and U+03A3 (Σ), whose lowercase is
            context-sensitive (Final_Sigma: σ mid-word, ς word-final).
    * lo1/lo2: the 1-2-codepoint lowercase expansion (lo2=0 when single).

    Cached on disk keyed by the Python version + Unicode data version —
    the ~0.3 s generation pass runs once per interpreter upgrade.
    """
    import re
    import sys
    import unicodedata

    cache = Path(
        os.environ.get("TENSOR_TRUTH_TPU_NATIVE_CACHE")
        or Path.home() / ".cache" / "tensortruth_tpu_native"
    )
    tag = f"{sys.version_info.major}.{sys.version_info.minor}-{unicodedata.unidata_version}"
    path = cache / f"uctables-{tag}.npz"
    if path.exists():
        try:
            with np.load(path) as z:
                return z["cls"], z["lo1"], z["lo2"]
        except Exception:
            pass  # corrupt cache — regenerate
    word = re.compile(r"\w", re.UNICODE).match
    space = re.compile(r"\s", re.UNICODE).match
    cls = np.zeros(0x10000, np.uint8)
    lo1 = np.zeros(0x10000, np.uint16)
    lo2 = np.zeros(0x10000, np.uint16)
    for cp in range(0x10000):
        if 0xD800 <= cp <= 0xDFFF or cp == 0x03A3:
            cls[cp] = 3
            continue
        ch = chr(cp)
        low = ch.lower()
        if len(low) > 2 or any(ord(c) > 0xFFFF for c in low):
            cls[cp] = 3
            continue
        cls[cp] = 1 if word(ch) else 2 if space(ch) else 0
        lo1[cp] = ord(low[0])
        lo2[cp] = ord(low[1]) if len(low) > 1 else 0
    try:
        cache.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.npz")
        np.savez(tmp, cls=cls, lo1=lo1, lo2=lo2)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is best-effort
    return cls, lo1, lo2


class HostKit:
    """Thin typed wrapper over the hostkit C ABI."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.tt_token_id.restype = ctypes.c_int64
        lib.tt_token_id.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.tt_encode_batch.restype = ctypes.c_int
        lib.tt_encode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tt_encode_offsets.restype = ctypes.c_int64
        lib.tt_encode_offsets.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.tt_set_tables.restype = None
        lib.tt_set_tables.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16),
        ]
        cls, lo1, lo2 = _unicode_tables()
        lib.tt_set_tables(
            cls.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lo1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            lo2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        )

    @staticmethod
    def _to_c(t: str) -> bytes:
        if "\x00" in t:
            raise ValueError("embedded NUL")  # c_char_p truncates at NUL
        try:
            return t.encode("utf-8")
        except UnicodeEncodeError:  # lone surrogates
            raise ValueError("unencodable") from None

    def token_id(self, token: str, vocab_size: int, n_special: int) -> int:
        return int(self._lib.tt_token_id(
            token.encode("utf-8"), vocab_size, n_special
        ))

    def encode_with_offsets(self, text: str, vocab_size: int, n_special: int):
        """Token ids + [start, end) character offsets, or None when the
        text needs the Python tokenizer (embedded NUL, astral-plane char,
        U+03A3) — the chunker's hot call, one C pass instead of one
        hashlib call per token."""
        try:
            c_text = self._to_c(text)
        except ValueError:
            return None
        cap = max(1, len(text))
        ids = np.empty(cap, dtype=np.int32)
        starts = np.empty(cap, dtype=np.int32)
        ends = np.empty(cap, dtype=np.int32)
        p = ctypes.POINTER(ctypes.c_int32)
        n = self._lib.tt_encode_offsets(
            c_text, vocab_size, n_special,
            ids.ctypes.data_as(p), starts.ctypes.data_as(p),
            ends.ctypes.data_as(p), cap,
        )
        if n < 0:
            return None
        return (
            ids[:n].tolist(),
            list(zip(starts[:n].tolist(), ends[:n].tolist())),
        )

    def encode_batch(
        self,
        texts,
        max_length: int,
        *,
        pair=None,
        vocab_size: int,
        pad_id: int,
        cls_id: int,
        sep_id: int,
        n_special: int,
    ):
        """Returns (ids, mask) int32 arrays, or None when any input needs
        the Python tokenizer (embedded NUL — c_char_p would silently
        truncate there — an astral-plane char, or U+03A3 whose lowercase
        is context-sensitive)."""
        n = len(texts)
        ids = np.full((n, max_length), pad_id, dtype=np.int32)
        mask = np.zeros((n, max_length), dtype=np.int32)
        CArr = ctypes.c_char_p * n
        try:
            c_texts = CArr(*[self._to_c(t) for t in texts])
            c_pairs = (
                CArr(*[self._to_c(t) for t in pair])
                if pair is not None else None
            )
        except ValueError:
            return None
        rc = self._lib.tt_encode_batch(
            c_texts, c_pairs, n, max_length, vocab_size,
            pad_id, cls_id, sep_id, n_special,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            return None
        return ids, mask


def _build() -> Path | None:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache = Path(
        os.environ.get("TENSOR_TRUTH_TPU_NATIVE_CACHE")
        or Path.home() / ".cache" / "tensortruth_tpu_native"
    )
    so = cache / f"hostkit-{tag}.so"
    if so.exists():
        return so
    cache.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".build{os.getpid()}.so")
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        str(_SRC), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning(
            "hostkit build failed (%s) — using the Python tokenizer: %s",
            e, detail.decode(errors="replace")[:500],
        )
        return None
    os.replace(tmp, so)  # atomic: concurrent builders converge on one file
    return so


def get_hostkit() -> HostKit | None:
    """Compile (once) and load the native hostkit; None when unavailable.

    Failure is remembered for the process so a missing toolchain costs one
    warning, not one subprocess per batch.
    """
    global _HOSTKIT, _TRIED
    if _HOSTKIT is not None or _TRIED:
        return _HOSTKIT
    with _LOCK:
        if _HOSTKIT is not None or _TRIED:
            return _HOSTKIT
        _TRIED = True
        if os.environ.get("TENSOR_TRUTH_TPU_NO_NATIVE"):
            return None
        so = _build()
        if so is None:
            return None
        try:
            _HOSTKIT = HostKit(ctypes.CDLL(str(so)))
        except OSError as e:
            logger.warning("hostkit load failed: %s", e)
            return None
        logger.info("native hostkit loaded: %s", so.name)
    return _HOSTKIT
