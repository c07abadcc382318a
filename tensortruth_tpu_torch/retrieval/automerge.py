"""Auto-merging retrieval: merge leaf hits up to their parents.

Copy of ``tensortruth_tpu/retrieval/automerge.py``: that package's ``__init__``
imports jax, so the port keeps its own copy; tests/unit/test_torch_retrieval.py
holds the two to the same outputs.

Reimplements the behavioral contract of LlamaIndex's ``AutoMergingRetriever``
as used by the reference (reference rag_engine.py:641-644,676-679; SURVEY.md
§2.1 "Auto-merging retrieval"): when more than ``ratio`` of one parent's
children appear in the retrieved set, the children are replaced by the parent
node (score = mean of the merged children), repeated until a fixed point so
merges can cascade leaf → mid → top level.

Runs host-side over the device top-k output (SURVEY.md §7 hard part (c)):
one dict pass per round over ≤ top-k entries — no per-query device traffic.
"""

from __future__ import annotations

from collections import defaultdict

from tensortruth_tpu_torch.index.nodes import HierarchyStore


def auto_merge(
    hits: list[tuple[str, float]],
    store: HierarchyStore,
    ratio: float = 0.5,
) -> list[tuple[str, float]]:
    """hits: (node_id, score) sorted desc. Returns merged (node_id, score) desc.

    ``ratio`` is the fraction of a parent's children that must be present to
    merge up (LlamaIndex ``simple_ratio_thresh`` default 0.5).
    """
    current = list(hits)
    while True:
        by_parent: dict[str, list[int]] = defaultdict(list)
        for i, (nid, _) in enumerate(current):
            if nid not in store:
                continue
            pid = store.parent_id_of(nid)
            if pid is not None and pid in store:
                by_parent[pid].append(i)

        merged_any = False
        drop: set[int] = set()
        additions: list[tuple[str, float]] = []
        present = {nid for nid, _ in current}
        for pid, positions in by_parent.items():
            n_children = store.n_children_of(pid)
            if n_children == 0 or pid in present:
                continue
            if len(positions) / n_children > ratio:
                score = sum(current[i][1] for i in positions) / len(positions)
                additions.append((pid, score))
                drop.update(positions)
                merged_any = True
        if not merged_any:
            return current
        current = [h for i, h in enumerate(current) if i not in drop] + additions
        current.sort(key=lambda x: -x[1])
