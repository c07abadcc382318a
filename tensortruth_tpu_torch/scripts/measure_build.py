"""Index-build throughput of the port on one CUDA card: the embed loop alone,
and chunking (host) plus embedding (card).

    python -m tensortruth_tpu_torch.scripts.measure_build   # from the repository root; needs one CUDA card

Port of the JAX package's ``scripts/measure_build_throughput.py`` and
``scripts/measure_e2e_build.py``, on the same synthetic inputs made from the
seed:

* 2048 leaves of 248 words (about 256 tokens each, seq bucket 256), for
  ``Embedder.encode`` alone;
* 48 markdown docs of 11,000 words each, with paragraph breaks, em-dashes
  and accented words, so that the native tokenizer meets what real corpora
  hold. They are chunked hierarchically twice, with the native tokenizer
  (``native/hostkit.cpp``) and with ``TENSOR_TRUTH_TPU_NO_NATIVE=1``, which
  must give the same nodes, and their leaves are embedded.

The encoder is BGE-M3 at full width with random weights (no checkpoint is
needed: the time does not depend on the weights). Every time is the host's
clock around a call that returns host arrays, so it includes the card's
work. Prints chunks/s and host seconds per stage, then one JSON line.
``chip_smoke.py`` calls :func:`run` on the embedder its build loaded.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

N_CHUNKS = 2048
WORDS = 248  # ~256 tokens per leaf chunk
N_DOCS = 48
WORDS_PER_DOC = 11_000  # ≈ 43 leaf chunks/doc
SEED = 0


def synth_chunks(n: int, seed: int = SEED) -> list[str]:
    """``n`` leaves of WORDS words drawn from a 5000-word vocabulary."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:04d}" for i in range(5000)]
    return [" ".join(rng.choice(vocab, WORDS)) for _ in range(n)]


def synth_docs(n: int, seed: int = SEED) -> list[str]:
    """``n`` markdown docs of WORDS_PER_DOC words; one word in seven has an
    umlaut, and a paragraph break with an em-dash follows every 180 words."""
    rng = np.random.default_rng(seed)
    vocab = [f"wörd{i:04d}" if i % 7 == 0 else f"word{i:04d}" for i in range(5000)]
    docs = []
    for _ in range(n):
        words = rng.choice(vocab, WORDS_PER_DOC)
        parts = []
        for i, w in enumerate(words):
            parts.append(w)
            if i % 180 == 179:
                parts.append("—\n\n")
        docs.append(" ".join(parts))
    return docs


def chunk_all(docs: list[str], tokenizer) -> list:
    """Every node of every doc under the default hierarchical strategy."""
    from tensortruth_tpu_torch.index.chunker import chunk_document

    nodes = []
    for i, text in enumerate(docs):
        nodes.extend(chunk_document(text, tokenizer, doc_id=f"d{i}", metadata={}))
    return nodes


def _reset_hostkit() -> None:
    from tensortruth_tpu_torch.native import hostkit

    hostkit._HOSTKIT, hostkit._TRIED = None, False


def measure_chunking(docs: list[str], tokenizer) -> dict:
    """Hierarchical chunking of ``docs`` with the native tokenizer, then with
    the Python one; both must give the same node texts. Returns the nodes
    and the host seconds of each."""
    chunk_all(docs[:2], tokenizer)  # warm: hostkit build and its tables
    t0 = time.perf_counter()
    nodes = chunk_all(docs, tokenizer)
    native_s = time.perf_counter() - t0
    os.environ["TENSOR_TRUTH_TPU_NO_NATIVE"] = "1"
    _reset_hostkit()
    try:
        t0 = time.perf_counter()
        nodes_py = chunk_all(docs, tokenizer)
        python_s = time.perf_counter() - t0
    finally:
        del os.environ["TENSOR_TRUTH_TPU_NO_NATIVE"]
        _reset_hostkit()
    if [n.text for n in nodes] != [n.text for n in nodes_py]:
        raise RuntimeError("native and Python chunking gave different nodes")
    leaves = [n for n in nodes if not n.child_ids]
    return {"nodes": nodes, "leaves": leaves, "native_s": native_s, "python_s": python_s}


def measure_encode(embedder, texts: list[str]) -> dict:
    """``Embedder.encode`` over ``texts`` after one warm-up call on the
    first 256 (the first launch of each bucket's kernels)."""
    t0 = time.perf_counter()
    embedder.encode(texts[:256])
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = embedder.encode(texts)
    seconds = time.perf_counter() - t0
    if out.shape != (len(texts), embedder.dim) or not np.isfinite(out).all():
        raise RuntimeError(f"encode gave {out.shape}, finite: {np.isfinite(out).all()}")
    return {"chunks": len(texts), "seconds": seconds, "chunks_per_s": len(texts) / seconds,
            "warmup_seconds": warm_s}


def run(embedder, n_chunks: int = N_CHUNKS, n_docs: int = N_DOCS) -> dict:
    """Encode alone over ``n_chunks`` leaves, then chunking and chunking +
    encode over ``n_docs`` docs, with ``embedder``. Returns the numbers it
    prints."""
    enc = measure_encode(embedder, synth_chunks(n_chunks))
    print(f"encode alone: {enc['chunks']} leaves of {WORDS} words in {enc['seconds']:.3f} s -> "
          f"{enc['chunks_per_s']:.1f} chunks/s (warm-up call {enc['warmup_seconds']:.3f} s)", flush=True)
    chunked = measure_chunking(synth_docs(n_docs), embedder.tokenizer)
    n_leaves = len(chunked["leaves"])
    emb = measure_encode(embedder, [n.text for n in chunked["leaves"]])
    result = {
        "encode_only": enc,
        "docs": n_docs,
        "nodes": len(chunked["nodes"]),
        "leaves": n_leaves,
        "chunk_native_s": chunked["native_s"],
        "chunk_python_s": chunked["python_s"],
        "embed_s": emb["seconds"],
        "build_chunks_per_s_native": n_leaves / (chunked["native_s"] + emb["seconds"]),
        "build_chunks_per_s_python": n_leaves / (chunked["python_s"] + emb["seconds"]),
    }
    print(f"chunking {n_docs} docs -> {result['nodes']} nodes ({n_leaves} leaves): native "
          f"{chunked['native_s']:.3f} s ({n_leaves / chunked['native_s']:.0f} leaves/s), python "
          f"{chunked['python_s']:.3f} s ({n_leaves / chunked['python_s']:.0f} leaves/s)", flush=True)
    print(f"embed {n_leaves} leaves: {emb['seconds']:.3f} s ({emb['chunks_per_s']:.1f} chunks/s)", flush=True)
    print(f"chunk + embed: {result['build_chunks_per_s_native']:.1f} chunks/s (native chunking), "
          f"{result['build_chunks_per_s_python']:.1f} chunks/s (python chunking) on {embedder.device}", flush=True)
    return result


def main() -> None:
    import torch

    from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec

    if not torch.cuda.is_available():
        raise SystemExit("measure_build needs a CUDA device")
    print(json.dumps(run(ModelManager.get_instance().get_embedder(ModelSpec("BAAI/bge-m3"), device="cuda"))))


if __name__ == "__main__":
    main()
