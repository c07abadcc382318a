"""The configuration's corpus: leaf and parent texts and the leaf rows.

Both come from the configuration's own fixed seed (``corpus_seed``), never
from ``--seed``, so every run of every cell over one configuration serves
the same module. The texts are a pure function of (seed, node): the
reference rebuilds any node's text without reading the program's store.

* Words: a pool of pseudo-words (letters only, so the offline tokenizer
  gives one token per word), and one long stream of them. Leaf ``j`` is
  ``c{j}`` followed by a slice of the stream, at the configuration's
  measured leaf-length mix (``chunk_words``); parent ``p`` is ``p{p}`` and
  a longer slice, four leaves under each parent.
* Rows: unit vectors drawn on the device in fixed chunks, rounded to
  bfloat16, so the engine's bf16 copy of them is exact.

The first run of a configuration in a checkout writes the module through
the program's ``VectorIndex.save`` into ``.cache/corpus/<config>/``, in a
process of its own, so the served process of that run starts as every later
run's does; later runs load it through the engine's normal load, as a
deployment starts.

    python3 -m benchmark_torch.harness.corpus <device> <tag> < config.json
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .common import CACHE, ROOT

ROW_CHUNK = 262_144
STREAM_WORDS = 1 << 20
SLICE_ROOM = 1024  # longest slice of the stream, in words


class Texts:
    """Node texts of one corpus, rebuilt from its seed."""

    def __init__(self, corpus: dict):
        self.corpus = corpus
        rng = np.random.default_rng(corpus["corpus_seed"])
        letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
        lengths = rng.integers(3, 10, size=corpus["word_pool"])
        self.pool = ["".join(rng.choice(letters, size=n)) for n in lengths]
        stream = rng.integers(0, len(self.pool), size=STREAM_WORDS + SLICE_ROOM)
        words = [self.pool[i] for i in stream]
        self.text = " ".join(words)
        lens = np.fromiter((len(w) for w in words), np.int64, count=len(words))
        self.start = np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
        self.end = self.start + lens
        self.chunk_words = list(corpus["chunk_words"])

    def _slice(self, at: int, n_words: int) -> str:
        a = at % STREAM_WORDS
        return self.text[self.start[a]: self.end[a + n_words - 1]]

    def leaf_words(self, j: int) -> int:
        return self.chunk_words[j % len(self.chunk_words)]

    def leaf(self, j: int) -> str:
        return f"c{j} " + self._slice(j * 7919, self.leaf_words(j) - 1)

    def parent(self, p: int) -> str:
        per = self.corpus["leaves_per_parent"]
        n = min(self.chunk_words[(p * per) % len(self.chunk_words)] * per, self.corpus["parent_words_max"])
        return f"p{p} " + self._slice(p * 104729 + 17, n - 1)

    def of_node(self, node_id: str) -> str:
        return self.leaf(int(node_id[1:])) if node_id[0] == "n" else self.parent(int(node_id[1:]))


def leaf_id(j: int) -> str:
    return f"n{j:08d}"


def parent_id(p: int) -> str:
    return f"p{p:08d}"


def rows_on_device(corpus: dict, device, lo: int = 0, hi: int | None = None):
    """Yield (first row, rows) chunks of the unit leaf rows in bf16, drawn
    on ``device`` from the corpus seed; chunk ``i`` always holds the same
    rows whichever range is asked for."""
    import torch

    n, d = corpus["n_leaves"], corpus["dim"]
    hi = n if hi is None else hi
    for c in range(lo // ROW_CHUNK, -(-hi // ROW_CHUNK)):
        a, b = c * ROW_CHUNK, min((c + 1) * ROW_CHUNK, n)
        gen = torch.Generator(device=device).manual_seed(corpus["corpus_seed"] * 1_000_003 + c)
        x = torch.randn((b - a, d), generator=gen, device=device, dtype=torch.float32)
        x = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(torch.bfloat16)
        yield a, x


def module_dir(config: dict, indexes_dir: Path) -> Path:
    from tensortruth_tpu_torch.index.store import sanitize_model_id

    return indexes_dir / sanitize_model_id(config["embedder"]["model_id"]) / f"library_{config['corpus']['module']}"


def _where(config: dict, tag: str) -> tuple[Path, Path, Path]:
    root = CACHE / "corpus" / (config["name"] + tag)
    return root, root / "indexes", root / "complete"


def ensure_corpus(config: dict, device, tag: str = "") -> tuple[Path, float]:
    """The indexes directory holding the configuration's module; writes it,
    in a process of its own, on the first call in this checkout. Returns
    (indexes dir, seconds spent writing, 0 when it was there)."""
    from tensortruth_tpu_torch.index.store import VectorIndex

    root, indexes_dir, done = _where(config, tag)
    if done.exists() and VectorIndex.is_valid(module_dir(config, indexes_dir)):
        return indexes_dir, 0.0
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "benchmark_torch.harness.corpus", str(device), tag], cwd=ROOT,
                   input=json.dumps(config), text=True, check=True)
    if not done.exists():
        raise RuntimeError(f"the corpus of {config['name']} was not written")
    return indexes_dir, time.perf_counter() - t0


def write_corpus(config: dict, device, tag: str) -> None:
    from tensortruth_tpu_torch.index.nodes import HierarchyStore, Node
    from tensortruth_tpu_torch.index.store import VectorIndex

    corpus = config["corpus"]
    root, indexes_dir, done = _where(config, tag)
    target = module_dir(config, indexes_dir)
    shutil.rmtree(root, ignore_errors=True)
    print(f"[corpus] writing {config['name']}: {corpus['n_leaves']} leaves", file=sys.stderr, flush=True)
    texts = Texts(corpus)
    n, per, module = corpus["n_leaves"], corpus["leaves_per_parent"], corpus["module"]
    store = HierarchyStore()
    row_ids = []
    for p in range(-(-n // per)):
        kids = [leaf_id(j) for j in range(p * per, min((p + 1) * per, n))]
        doc = f"d{p // 256}"
        store.add(Node(node_id=parent_id(p), text=texts.parent(p), level=0, doc_id=doc, module=module,
                       child_ids=kids))
        for j in range(p * per, min((p + 1) * per, n)):
            store.add(Node(node_id=leaf_id(j), text=texts.leaf(j), level=1, doc_id=doc, module=module,
                           parent_id=parent_id(p)))
        row_ids.extend(kids)
    store.finalize_leaves()
    emb = np.empty((n, corpus["dim"]), dtype=np.float32)
    for a, x in rows_on_device(corpus, device):
        emb[a: a + x.shape[0]] = x.float().cpu().numpy()
    VectorIndex(emb, row_ids, store, metadata={
        "embedding_model": config["embedder"]["model_id"], "created_at": "benchmark corpus",
        "index_version": "1.0", "chunk_sizes": [2048, 512, 256], "chunk_overlap": 64,
        "chunking_strategy": "hierarchical", "gelu": "exact",
    }).save(target)
    # The write back of these gigabytes would otherwise run on into the
    # first window and slow its host: finish it inside set-up.
    os.sync()
    done.write_text("ok\n")


if __name__ == "__main__":
    write_corpus(json.load(sys.stdin), sys.argv[1], sys.argv[2])
