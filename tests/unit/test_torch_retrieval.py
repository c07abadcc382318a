"""The port's retrieval core against the reference's on the same inputs.

* ``retrieval/{automerge,ranking,metrics}.py`` are copies: they must give the
  originals' outputs exactly.
* ``MultiIndexEngine``: the same ``VectorIndex`` set (built by each package
  from the same inputs) gives the same ``RetrievedNode`` ids, modules and order, with scores within 1e-6 (both
  stack a bf16 corpus and sum exact bf16 products in float32, in different
  orders), for 1 and 3 modules, both balance strategies, and corpora below
  and above the 4096-row exact/fused cut-over (the reference's Pallas kernel
  in interpret mode, the port's plain version).
"""

import copy

import numpy as np
import pytest
import torch

from tensortruth_tpu import index as ref_index
from tensortruth_tpu.core.source import SourceNode as RefSourceNode
from tensortruth_tpu.retrieval import automerge as ref_automerge
from tensortruth_tpu.retrieval import metrics as ref_metrics
from tensortruth_tpu.retrieval import ranking as ref_ranking
from tensortruth_tpu.retrieval.engine import MultiIndexEngine as RefEngine
from tensortruth_tpu_torch import index as port_index
from tensortruth_tpu_torch.core.source import SourceNode
from tensortruth_tpu_torch.parallel import make_mesh
from tensortruth_tpu_torch.retrieval import automerge, metrics, ranking
from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine

torch.set_num_threads(1)

DIM = 32


def _module(name: str, n_parents: int, kids: int, seed: int, pkg=port_index):
    """n_parents parents with ``kids`` leaves each; siblings embed near their
    parent's centroid so a query near it retrieves them together (merges).
    ``pkg`` is the index package whose classes hold it (the port's or the
    reference's): the two packages' classes are not the same classes."""
    Node = pkg.Node
    rng = np.random.default_rng(seed)
    store = pkg.HierarchyStore()
    rows = []
    centroids = rng.standard_normal((n_parents, DIM)).astype(np.float32)
    for p in range(n_parents):
        pid = f"{name}-p{p}"
        kid_ids = [f"{pid}-c{c}" for c in range(kids)]
        meta = {"filename": f"{name}_{p % 5}.md", "doc_type": "library"}
        store.add(Node(node_id=pid, text=f"parent {p} of {name}", level=0, doc_id=f"{name}{p % 5}",
                       module=name, child_ids=list(kid_ids), metadata=meta))
        for c, kid in enumerate(kid_ids):
            store.add(Node(node_id=kid, text=f"leaf {c} of {pid}", level=1, doc_id=f"{name}{p % 5}",
                           module=name, parent_id=pid, metadata=meta))
            rows.append(centroids[p] + 0.3 * rng.standard_normal(DIM).astype(np.float32))
    row_ids = store.finalize_leaves()
    emb = np.stack(rows)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return pkg.VectorIndex(emb, row_ids, store, {"embedding_model": "tiny-embedder"})


def _modules(parents, names=None):
    """The same modules built by each package: (reference's, port's)."""
    names = names or [f"mod{i}" for i in range(len(parents))]
    return tuple(
        {name: _module(name, n, 3, seed=i, pkg=pkg) for i, (name, n) in enumerate(zip(names, parents))}
        for pkg in (ref_index, port_index)
    )


def _queries(indexes, n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(DIM)]  # a random direction
    for idx in indexes.values():  # near a parent's centroid: merges happen
        m, _ = idx.matrix()
        for _ in range(max(1, (n - 1) // len(indexes))):
            p = rng.integers(0, m.shape[0] // 3)
            out.append(m[3 * p : 3 * p + 3].mean(axis=0))
    q = np.stack(out).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _flat(results):
    return [[(r.node_id, r.module, r.source_index, r.score) for r in rs] for rs in results]


def _assert_same(want, got):
    assert [[x[:3] for x in rs] for rs in got] == [[x[:3] for x in rs] for rs in want]
    for rw, rg in zip(want, got):
        np.testing.assert_allclose([x[3] for x in rg], [x[3] for x in rw], atol=1e-6, rtol=0)


# (module parent counts, balance strategy, use_fused)
ENGINE_CASES = [
    ((60,), "top_k_per_index", None),
    ((60, 25, 40), "top_k_per_index", None),
    ((60, 25, 40), "none", None),
    ((900, 300, 400), "top_k_per_index", True),  # 4800 rows: fused path
    ((900, 300, 400), "none", True),
    ((1800,), "top_k_per_index", True),  # 5400 rows, one module
    ((900, 300, 400), "top_k_per_index", False),  # exact above 4096
]


@pytest.mark.parametrize("parents,balance,use_fused", ENGINE_CASES)
def test_engine_matches_reference(parents, balance, use_fused):
    ref_indexes, indexes = _modules(parents)
    kw = dict(similarity_top_k=10, balance_strategy=balance, use_fused=use_fused)
    want_engine = RefEngine(ref_indexes, **kw)
    got_engine = MultiIndexEngine(indexes, device="cpu", **kw)
    assert got_engine.n_chunks == want_engine.n_chunks == 3 * sum(parents)
    assert got_engine._stacked.shape[0] % 2048 == 0 and got_engine._stacked.dtype == torch.bfloat16
    q = _queries(indexes)
    want, got = _flat(want_engine.retrieve_batch(q)), _flat(got_engine.retrieve_batch(q))
    _assert_same(want, got)
    assert any(nid.endswith(tuple(f"-p{i}" for i in range(2000))) for rs in got for nid, *_ in rs)  # merged


def test_engine_single_query_cache_matches_reference():
    ref_indexes, indexes = _modules((50, 30), names=["a", "b"])
    want_engine, got_engine = RefEngine(ref_indexes), MultiIndexEngine(indexes, device="cpu")
    q = _queries(indexes, n=3)
    for i, text in enumerate(["x", "y", "x"]):
        _assert_same(_flat([want_engine.retrieve(q[i % 2], text)]), _flat([got_engine.retrieve(q[i % 2], text)]))
    assert list(got_engine._cache) == ["y", "x"]
    got_engine.clear_cache()
    assert not got_engine._cache


def test_engine_refuses_unported_tiers():
    """No tier is refused any more: the int8 and IVF tiers build, and so
    does a mesh engine (their parity with the reference is in
    test_torch_int8.py, test_torch_ivf.py and test_torch_parallel.py)."""
    indexes = {"a": _module("a", 20, 3, seed=7)}
    assert MultiIndexEngine(indexes, device="cpu", corpus_dtype="int8", use_fused=True)._stacked_scales is not None
    assert MultiIndexEngine(indexes, device="cpu", ivf_threshold=10, ivf_clusters=4)._ivf is not None
    mesh = make_mesh(n_shards=2, devices=["cpu", "cpu"])
    engine = MultiIndexEngine(indexes, mesh=mesh)
    assert engine.mesh is mesh and engine._stacked.mesh is mesh and all(engine.retrieve_batch(_queries(indexes)))


def test_empty_engine():
    assert MultiIndexEngine({}, device="cpu").retrieve_batch(np.zeros((2, DIM), np.float32)) == [[], []]


@pytest.mark.parametrize("seed", range(4))
def test_auto_merge_copy_matches_original(seed):
    idx, ref_idx = _module("m", 20, 3, seed=seed), _module("m", 20, 3, seed=seed, pkg=ref_index)
    rng = np.random.default_rng(seed)
    leaves = list(idx.store.leaf_ids)
    assert leaves == list(ref_idx.store.leaf_ids)
    picks = rng.choice(len(leaves), size=12, replace=False)
    hits = sorted(((leaves[i], float(rng.random())) for i in picks), key=lambda h: -h[1])
    for ratio in (0.3, 0.5, 0.9):
        assert automerge.auto_merge(hits, idx.store, ratio) == ref_automerge.auto_merge(hits, ref_idx.store, ratio)


def _sources(seed, cls=SourceNode):
    rng = np.random.default_rng(seed)
    return [
        cls(id=f"s{i}", content=f"text {i} " * int(rng.integers(1, 30)),
                   score=float(rng.random()), metadata={"filename": f"f{i % 3}.md", "doc_type": "library"})
        for i in range(8)
    ]


class _FakeReranker:
    def __init__(self, seed):
        self.seed = seed

    def rerank(self, query, docs, top_n):
        scores = np.random.default_rng(self.seed).random(len(docs)).astype(np.float32)
        return np.argsort(-scores, kind="stable")[:top_n], scores


@pytest.mark.parametrize("seed,top_n,threshold", [(0, 5, 0.0), (1, 8, 0.4), (2, 3, 0.9)])
def test_ranking_and_gate_copies_match_originals(seed, top_n, threshold):
    a, b = _sources(seed, RefSourceNode), _sources(seed)
    ra = ref_ranking.RankingStage(_FakeReranker(seed), threshold=threshold).rank(a, "q", "be brief", top_n)
    rb = ranking.RankingStage(_FakeReranker(seed), threshold=threshold).rank(b, "q", "be brief", top_n)
    assert [s.to_dict() for s in rb.all_sources] == [s.to_dict() for s in ra.all_sources]
    assert rb.scores == ra.scores
    for cut in ((0.35, 0.05), (0.9, 0.05), (0.99, 0.98)):
        ka, la = ref_ranking.apply_confidence_gate(copy.deepcopy(ra.passed), *cut)
        kb, lb = ranking.apply_confidence_gate(copy.deepcopy(rb.passed), *cut)
        assert [s.id for s in kb] == [s.id for s in ka] and lb.value == la.value


@pytest.mark.parametrize("seed", range(3))
def test_metrics_copy_matches_original(seed):
    srcs, ref_srcs = _sources(seed)[: seed + 1], _sources(seed, RefSourceNode)[: seed + 1]
    assert metrics.compute_retrieval_metrics(srcs).to_dict() == ref_metrics.compute_retrieval_metrics(ref_srcs).to_dict()
    assert metrics.calculate_entropy([3, 1, 0, 2]) == ref_metrics.calculate_entropy([3, 1, 0, 2])
