"""Host-side tokenization.

Tokenization stays on the host (reference keeps it inside HF models via the
Rust ``tokenizers`` wheel — SURVEY.md §0 table row "Tokenization"). The engine
only needs two capabilities from a tokenizer:

1. ``encode_with_offsets`` — token ids plus character spans, used by the
   hierarchical chunker to cut chunk *text* at token boundaries
   (replaces LlamaIndex node parsers, reference indexing/builder.py:383-418).
2. ``encode_batch`` — padded id/mask arrays for the TPU encoder.

Two implementations:

* :class:`HFTokenizer` — wraps a HuggingFace ``tokenizers`` fast tokenizer
  loaded from a local ``tokenizer.json`` (the real XLM-R sentencepiece vocab
  for BGE-M3 when model files are present on disk).
* :class:`SimpleTokenizer` — deterministic, dependency-free fallback used in
  tests and offline environments: regex word/punct split, stable-hash ids.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import Protocol, Sequence

import numpy as np


class Tokenizer(Protocol):
    """Minimal tokenizer interface the engine depends on."""

    vocab_size: int
    pad_id: int
    cls_id: int
    sep_id: int

    def encode_with_offsets(self, text: str) -> tuple[list[int], list[tuple[int, int]]]:
        """Token ids and [start, end) character offsets, no special tokens."""
        ...

    def encode(self, text: str) -> list[int]:
        ...

    def encode_batch(
        self, texts: Sequence[str], max_length: int, pair: Sequence[str] | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Return (ids, mask) int32 arrays of shape (B, max_length)."""
        ...


_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


@dataclass
class SimpleTokenizer:
    """Deterministic offline tokenizer: regex split + stable hash ids.

    Ids 0..4 are reserved: pad=0, cls=1, sep=2, unk=3, mask=4 (mirrors the
    XLM-R special-token layout so batch-shaping code is identical for both
    tokenizers).
    """

    vocab_size: int = 250002
    pad_id: int = 0
    cls_id: int = 1
    sep_id: int = 2
    unk_id: int = 3
    mask_id: int = 4
    n_special: int = 5
    # Pair layout: "xlmr" = <s> a </s></s> b </s>, "bert" = [CLS] a [SEP] b [SEP]
    sep_style: str = "xlmr"

    def _token_id(self, token: str) -> int:
        h = hashlib.blake2b(token.lower().encode("utf-8"), digest_size=8).digest()
        return self.n_special + int.from_bytes(h, "little") % (
            self.vocab_size - self.n_special
        )

    def encode_with_offsets(self, text: str) -> tuple[list[int], list[tuple[int, int]]]:
        # Native fast path (native/hostkit.cpp tt_encode_offsets): identical
        # output for any BMP text, one C pass instead of one hashlib call
        # per token — this is the chunker's hot loop at build time. Falls
        # back to the Python reference below for NUL/astral/Σ input or
        # when no toolchain exists.
        from tensortruth_tpu_torch.native import get_hostkit

        kit = get_hostkit()
        if kit is not None:
            out = kit.encode_with_offsets(text, self.vocab_size, self.n_special)
            if out is not None:
                return out
        ids: list[int] = []
        offsets: list[tuple[int, int]] = []
        for m in _WORD_RE.finditer(text):
            ids.append(self._token_id(m.group(0)))
            offsets.append((m.start(), m.end()))
        return ids, offsets

    def encode(self, text: str) -> list[int]:
        return self.encode_with_offsets(text)[0]

    def encode_batch(
        self, texts: Sequence[str], max_length: int, pair: Sequence[str] | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        # Native fast path (native/hostkit.cpp): identical output for any
        # BMP text (Unicode semantics come from Python-generated tables),
        # ~an order of magnitude faster on the single host core this
        # environment provides — and host tokenization sits on the serving
        # critical path (Reranker.score_pairs tokenizes B*top_k pairs per
        # batch before the rerank dispatch). Returns None for text the
        # tables can't answer (NUL, astral plane, Σ) or when no C++
        # toolchain exists; then the pure-Python loop below owns the call
        # (it is also the parity reference under test).
        from tensortruth_tpu_torch.native import get_hostkit

        kit = get_hostkit()
        if kit is not None and self.sep_style == "xlmr":
            # (native kit implements the XLM-R pair layout only)
            out = kit.encode_batch(
                texts, max_length, pair=pair,
                vocab_size=self.vocab_size, pad_id=self.pad_id,
                cls_id=self.cls_id, sep_id=self.sep_id,
                n_special=self.n_special,
            )
            if out is not None:
                return out
        return _batch_encode(self, texts, max_length, pair)


class HFTokenizer:
    """HuggingFace fast-tokenizer wrapper (local files only, no network)."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer as _RustTokenizer

        self._tok = _RustTokenizer.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()
        vocab = self._tok.get_vocab()
        if "[SEP]" in vocab:
            # BERT/WordPiece family (MiniLM etc.): single-SEP pair layout
            self.pad_id = vocab.get("[PAD]", 0)
            self.cls_id = vocab.get("[CLS]", 101)
            self.sep_id = vocab.get("[SEP]", 102)
            self.sep_style = "bert"
        else:
            self.pad_id = vocab.get("<pad>", 1)
            self.cls_id = vocab.get("<s>", 0)
            self.sep_id = vocab.get("</s>", 2)
            self.sep_style = "xlmr"

    def encode_with_offsets(self, text: str) -> tuple[list[int], list[tuple[int, int]]]:
        enc = self._tok.encode(text, add_special_tokens=False)
        return list(enc.ids), [tuple(o) for o in enc.offsets]

    def encode(self, text: str) -> list[int]:
        return self.encode_with_offsets(text)[0]

    def encode_batch(
        self, texts: Sequence[str], max_length: int, pair: Sequence[str] | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        return _batch_encode(self, texts, max_length, pair)


def _batch_encode(
    tok, texts: Sequence[str], max_length: int, pair: Sequence[str] | None
) -> tuple[np.ndarray, np.ndarray]:
    """Shared CLS/SEP batch shaping.

    Pair layout follows the tokenizer's family (``sep_style``): XLM-R
    cross-encoders use ``<s> a </s></s> b </s>`` (the inputs the reference's
    sentence-transformers stack builds, reference model_manager.py:333-337);
    BERT-family rerankers use ``[CLS] a [SEP] b [SEP]`` with segment ids
    derived downstream from the single separator (models/reranker.py).
    """
    bsz = len(texts)
    ids = np.full((bsz, max_length), tok.pad_id, dtype=np.int32)
    mask = np.zeros((bsz, max_length), dtype=np.int32)
    bert_pairs = getattr(tok, "sep_style", "xlmr") == "bert"
    n_sep = 3 if bert_pairs else 4  # specials in a pair sequence
    # Tokenize each unique string once: rerank batches repeat the same query
    # across all of its candidate docs (N pairs share ~N/top_k queries), so
    # memoizing here nearly halves host tokenize time on the serving path.
    cache: dict[str, list[int]] = {}

    def enc(t: str) -> list[int]:
        got = cache.get(t)
        if got is None:
            got = cache[t] = tok.encode(t)
        return got

    for i, text in enumerate(texts):
        a = enc(text)
        if pair is None:
            seq = [tok.cls_id] + a[: max_length - 2] + [tok.sep_id]
        else:
            b = enc(pair[i])
            # Budget: favour the query (a) up to half, rest to the doc.
            a_budget = min(len(a), max(1, (max_length - n_sep) // 2))
            b_budget = max_length - n_sep - a_budget
            mid = [tok.sep_id] if bert_pairs else [tok.sep_id, tok.sep_id]
            seq = (
                [tok.cls_id]
                + a[:a_budget]
                + mid
                + b[:b_budget]
                + [tok.sep_id]
            )
        seq = seq[:max_length]
        ids[i, : len(seq)] = seq
        mask[i, : len(seq)] = 1
    return ids, mask


def load_tokenizer(path: str | None = None, sep_style: str = "xlmr") -> Tokenizer:
    """Load the real tokenizer from a local file, else the offline fallback.

    ``sep_style`` only shapes the FALLBACK: a real tokenizer.json declares
    its own family via its special tokens. The model manager passes "bert"
    for BERT-family architectures so pair layout + segment ids stay
    consistent even without a tokenizer file."""
    if path is not None:
        return HFTokenizer(path)
    return SimpleTokenizer(sep_style=sep_style)
