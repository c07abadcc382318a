"""The port's multi-process global mesh over real cross-process collectives.

Two OS processes on the CPU form one gloo world of 2, each with a local mesh
of 2 ``cpu`` shards (4 in all), through
``tensortruth_tpu_torch.scripts.global_mesh_worker``. Each reads and places
only its own rows of one index on disk; the last rank serves the queries
(never assumed to be rank 0). Both ranks must return the same results, equal
to a numpy brute force (float32 rows, exact per-shard path: the same ids,
scores within 1e-5) and, for the int8 tier, equal to the single-process
sharded search over the same rows; ``GlobalMeshIVF`` probing every cluster
must return the brute force's ids. The world has a hard timeout of 60 s in
all: ``run_world`` kills the workers when it fires.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tensortruth_tpu_torch.index import HierarchyStore, Node, VectorIndex
from tensortruth_tpu_torch.parallel import make_mesh
from tensortruth_tpu_torch.parallel.sharded_topk import shard_corpus_int8, sharded_topk_search
from tensortruth_tpu_torch.scripts.global_mesh_worker import run_world

torch.set_num_threads(1)

N, D, K, B = 1000, 64, 10, 5
TILE = 128  # small shapes: each shard is 256 rows, not 2048
TIMEOUT_S = 60


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _index(path: Path, emb: np.ndarray) -> None:
    store = HierarchyStore()
    store.add_all([Node(node_id=f"n{i}", text=f"t{i}", level=0, doc_id="d") for i in range(len(emb))])
    store.finalize_leaves()
    VectorIndex(emb, [f"n{i}" for i in range(len(emb))], store, {"embedding_model": "tiny"}).save(path)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both workers' reports, the corpus and the queries."""
    work = tmp_path_factory.mktemp("global_mesh")
    rng = np.random.default_rng(7)
    corpus = _normed(rng, N, D)
    _index(work / "a", corpus[:600])
    _index(work / "b", corpus[600:])
    q = _normed(rng, B, D)
    np.save(work / "q.npy", q)
    args = ["--backend", "gloo", "--device", "cpu", "--local-shards", "2", "--index", str(work / "a"),
            "--index", str(work / "b"), "--queries", str(work / "q.npy"), "--k", str(K), "--tile-n", str(TILE),
            "--ivf-clusters", "16", "--timeout", str(TIMEOUT_S)]
    reports = run_world([args, args], work, timeout=TIMEOUT_S, env={"OMP_NUM_THREADS": "1"})
    return reports, corpus, q


def test_ranks_own_disjoint_halves(two_ranks):
    reports, _, _ = two_ranks
    (s0, e0, pad0), (s1, e1, pad1) = (r["row_range"] for r in reports)
    assert (s0, e1, pad0, pad1) == (0, 1024, 1024, 1024) and e0 == s1 == 512
    assert [r["cluster_range"] for r in reports] == [[0, 8, 16], [8, 16, 16]]


@pytest.mark.parametrize("tier", ["float32", "int8", "ivf"])
def test_both_ranks_agree(two_ranks, tier):
    reports, _, _ = two_ranks
    a, b = (r["searches"][tier] for r in reports)
    assert a["ids"] == b["ids"] and a["scores"] == b["scores"]


def test_float32_and_ivf_match_brute_force(two_ranks):
    reports, corpus, q = two_ranks
    ref = q @ corpus.T
    ref_ids = np.argsort(-ref, axis=1, kind="stable")[:, :K]
    for tier in ("float32", "ivf"):
        got = reports[0]["searches"][tier]
        np.testing.assert_array_equal(np.asarray(got["ids"]), ref_ids)
        np.testing.assert_allclose(np.asarray(got["scores"]), np.take_along_axis(ref, ref_ids, axis=1), atol=1e-5)


def test_int8_matches_single_process_sharded_search(two_ranks):
    reports, corpus, q = two_ranks
    emb, n = shard_corpus_int8(corpus, make_mesh(n_shards=4, devices=["cpu"] * 4), tile_n=TILE)
    vals, ids = sharded_topk_search(q, emb, K, n, tile_n=TILE)
    got = reports[1]["searches"]["int8"]
    np.testing.assert_array_equal(np.asarray(got["ids"]), ids)
    np.testing.assert_allclose(np.asarray(got["scores"]), vals, atol=1e-6)
