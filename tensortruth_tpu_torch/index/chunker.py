"""Hierarchical, semantic, and semantic-hierarchical chunking.

Re-implements the behavioral contract of the reference's three chunking
strategies (reference indexing/builder.py:48-65, 380-418):

* ``hierarchical`` — token-window split at sizes [2048, 512, 256] with
  overlap 64, children cut from each parent's text, parent↔child links kept
  (LlamaIndex ``HierarchicalNodeParser`` semantics).
* ``semantic`` — embedding-based breakpoints: split at sentence boundaries
  where adjacent-sentence cosine distance exceeds a percentile threshold
  (``SemanticSplitterNodeParser``, buffer_size 1, percentile 95).
* ``semantic_hierarchical`` — semantic top-level sections, hierarchical
  windows within each section (two-pass, builder.py:400-418).

All functions are host-side pure Python over tokenizer offsets; the only
device work (semantic embeddings) is injected via an ``embed_fn`` callable so
the chunker itself has no JAX dependency.
"""

from __future__ import annotations

import re
from enum import Enum
from typing import Callable, Sequence

import numpy as np

from tensortruth_tpu_torch.index.nodes import HierarchyStore, Node, new_node_id

DEFAULT_CHUNK_SIZES = [2048, 512, 256]
DEFAULT_CHUNK_OVERLAP = 64


class ChunkingStrategy(str, Enum):
    HIERARCHICAL = "hierarchical"
    SEMANTIC = "semantic"
    SEMANTIC_HIERARCHICAL = "semantic_hierarchical"


def _token_windows(
    n_tokens: int, size: int, overlap: int
) -> list[tuple[int, int]]:
    """[start, end) token-index windows with overlap; last window may be short."""
    if n_tokens <= size:
        return [(0, n_tokens)] if n_tokens > 0 else []
    step = max(1, size - overlap)
    windows = []
    start = 0
    while start < n_tokens:
        end = min(start + size, n_tokens)
        windows.append((start, end))
        if end == n_tokens:
            break
        start += step
    return windows


def _split_level(
    text: str,
    tokenizer,
    size: int,
    overlap: int,
    base_char: int,
) -> list[tuple[str, int, int]]:
    """Split text into token windows; returns (chunk_text, abs_start, abs_end)."""
    ids, offsets = tokenizer.encode_with_offsets(text)
    if not ids:
        return []
    out = []
    for ts, te in _token_windows(len(ids), size, overlap):
        cs, ce = offsets[ts][0], offsets[te - 1][1]
        out.append((text[cs:ce], base_char + cs, base_char + ce))
    return out


def hierarchical_chunk(
    text: str,
    tokenizer,
    doc_id: str,
    module: str = "",
    chunk_sizes: Sequence[int] = DEFAULT_CHUNK_SIZES,
    chunk_overlap: int = DEFAULT_CHUNK_OVERLAP,
    metadata: dict | None = None,
) -> list[Node]:
    """Multi-level token-window split with parent↔child links.

    Level 0 nodes are cut from the document; level i+1 nodes are cut from each
    level-i node's text. Returns ALL nodes (callers embed only the leaves,
    matching reference builder.py:420-442).
    """
    if chunk_overlap >= min(chunk_sizes):
        raise ValueError(
            f"chunk_overlap ({chunk_overlap}) must be smaller than the smallest "
            f"chunk size ({min(chunk_sizes)})"
        )
    metadata = metadata or {}
    all_nodes: list[Node] = []

    def build(level: int, parent: Node | None, text_: str, base: int) -> list[Node]:
        chunks = _split_level(text_, tokenizer, chunk_sizes[level], chunk_overlap, base)
        nodes = []
        for chunk_text, s, e in chunks:
            node = Node(
                node_id=new_node_id(),
                text=chunk_text,
                level=level,
                doc_id=doc_id,
                module=module,
                parent_id=parent.node_id if parent else None,
                start=s,
                end=e,
                metadata=dict(metadata),
            )
            nodes.append(node)
            all_nodes.append(node)
            if parent is not None:
                parent.child_ids.append(node.node_id)
            if level + 1 < len(chunk_sizes):
                build(level + 1, node, chunk_text, s)
        return nodes

    build(0, None, text, 0)
    return all_nodes


_SENT_RE = re.compile(r"(?<=[.!?])\s+|\n{2,}")


def split_sentences(text: str) -> list[tuple[str, int, int]]:
    """Sentence-ish spans (text, start, end); splits on punctuation + blank lines."""
    spans = []
    pos = 0
    for m in _SENT_RE.finditer(text):
        seg = text[pos : m.start()]
        if seg.strip():
            spans.append((seg, pos, m.start()))
        pos = m.end()
    tail = text[pos:]
    if tail.strip():
        spans.append((tail, pos, len(text)))
    return spans


def semantic_breakpoints(
    sentences: list[str],
    embed_fn: Callable[[list[str]], np.ndarray],
    buffer_size: int = 1,
    breakpoint_percentile: float = 95.0,
) -> list[int]:
    """Indices i where a new section starts AFTER sentence i.

    Distance = 1 - cosine(group_i, group_{i+1}) with each group sentence i
    plus ``buffer_size`` neighbors on BOTH sides — the smoothing window the
    reference's SemanticSplitterNodeParser uses (buffer_size=1 → 3-sentence
    groups; a trailing-only window gave zero smoothing at the default and
    noisier boundaries). Reference builder.py:391-398 params.
    """
    if len(sentences) < 2:
        return []
    groups = []
    for i in range(len(sentences)):
        lo, hi = max(0, i - buffer_size), min(len(sentences), i + buffer_size + 1)
        groups.append(" ".join(sentences[lo:hi]))
    emb = np.asarray(embed_fn(groups), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9
    sims = (emb[:-1] * emb[1:]).sum(axis=1)
    dists = 1.0 - sims
    thresh = np.percentile(dists, breakpoint_percentile)
    return [i for i, d in enumerate(dists) if d > thresh]


def semantic_chunk(
    text: str,
    tokenizer,
    doc_id: str,
    embed_fn: Callable[[list[str]], np.ndarray],
    module: str = "",
    buffer_size: int = 1,
    breakpoint_percentile: float = 95.0,
    metadata: dict | None = None,
) -> list[Node]:
    """Single-level semantic sections as leaf nodes."""
    metadata = metadata or {}
    sents = split_sentences(text)
    if not sents:
        return []
    breaks = set(
        semantic_breakpoints(
            [s for s, _, _ in sents], embed_fn, buffer_size, breakpoint_percentile
        )
    )
    nodes: list[Node] = []
    sec_start = 0
    for i in range(len(sents)):
        if i in breaks or i == len(sents) - 1:
            s0, e0 = sents[sec_start][1], sents[i][2]
            nodes.append(
                Node(
                    node_id=new_node_id(),
                    text=text[s0:e0],
                    level=0,
                    doc_id=doc_id,
                    module=module,
                    start=s0,
                    end=e0,
                    metadata=dict(metadata),
                )
            )
            sec_start = i + 1
    return nodes


def semantic_hierarchical_chunk(
    text: str,
    tokenizer,
    doc_id: str,
    embed_fn: Callable[[list[str]], np.ndarray],
    module: str = "",
    chunk_sizes: Sequence[int] = DEFAULT_CHUNK_SIZES,
    chunk_overlap: int = DEFAULT_CHUNK_OVERLAP,
    buffer_size: int = 1,
    breakpoint_percentile: float = 95.0,
    metadata: dict | None = None,
) -> list[Node]:
    """Two-pass: semantic sections, then hierarchical windows inside each."""
    sections = semantic_chunk(
        text, tokenizer, doc_id, embed_fn, module,
        buffer_size, breakpoint_percentile, metadata,
    )
    all_nodes: list[Node] = []
    for sec in sections:
        sub = hierarchical_chunk(
            sec.text, tokenizer, doc_id, module, chunk_sizes, chunk_overlap, metadata
        )
        # Re-base character spans onto the full document.
        for n in sub:
            n.start += sec.start
            n.end += sec.start
        all_nodes.extend(sub)
    return all_nodes


def chunk_document(
    text: str,
    tokenizer,
    doc_id: str,
    strategy: ChunkingStrategy | str = ChunkingStrategy.HIERARCHICAL,
    embed_fn: Callable[[list[str]], np.ndarray] | None = None,
    **kwargs,
) -> list[Node]:
    """Strategy dispatch (reference builder.py:380-418)."""
    strategy = ChunkingStrategy(strategy)
    if strategy is ChunkingStrategy.HIERARCHICAL:
        return hierarchical_chunk(text, tokenizer, doc_id, **kwargs)
    if embed_fn is None:
        raise ValueError(f"strategy {strategy.value} requires embed_fn")
    if strategy is ChunkingStrategy.SEMANTIC:
        kwargs.pop("chunk_sizes", None)
        kwargs.pop("chunk_overlap", None)
        return semantic_chunk(text, tokenizer, doc_id, embed_fn, **kwargs)
    return semantic_hierarchical_chunk(text, tokenizer, doc_id, embed_fn, **kwargs)


def build_hierarchy(nodes: list[Node]) -> HierarchyStore:
    store = HierarchyStore()
    store.add_all(nodes)
    store.finalize_leaves()
    return store
