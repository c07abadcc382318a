"""The comparison that decides ``correct``.

What the timed path produced, for a sample of the window's messages drawn
from the seed (the longest query always in it), is held against the plain
float32 reference of the configuration (``configs/<reference>.py``), run
after the program's state is freed. Each message brings the candidates the
search handed to the reranker (node id and the search's dot product) and the
sources its ``sources`` frame carried (node id and rerank score). The
reference rebuilds the weights from the seed and the texts and rows from the
corpus seed; it takes nothing the program made. Numbers, each the widest
over the sample:

* ``search_dot_gap``: |program dot - reference dot| of each candidate leaf
  (the query encoder and the search's arithmetic and row ids);
* ``search_rank_gap``: how far the weakest candidate lies below the
  reference's exact k-th best dot (the search picks the top k); compared
  only where the configuration's tier is exact by design;
* ``rerank_score_gap``: |program score - reference score| of each source
  (the cross-encoder and its inputs);
* ``selection_gap``: the selection of the sources among the candidates
  (the sort, the hard cutoff, the top n), tie-aware: the most by which the
  reference score of the i-th source lies below the reference's i-th best
  among the same candidates, or below the hard cutoff, and by which the
  reference score of a source left out lies above the cutoff when the
  reference keeps more. A program whose every candidate's score lies within
  e of the reference's, and which sorts by its own scores, reads at most
  2e here; near ties within that may swap;
* ``selection_faults``: sources beyond the top n, not among the
  candidates, or given twice; exact, limit 0.

``control_records`` puts the reference in the program's place at a lower
precision (float8 e4m3 operands), with the served path's policy: exact top
k, auto-merge, rerank, the hard cutoff, the top n. It must fail a limit.
With ``order`` it plants a selection fault instead: ``reverse`` gives the
top n in ascending order, ``ascending`` the n lowest.
"""

from __future__ import annotations

import importlib.util
import math
import random
import sys
from dataclasses import dataclass, field

from .common import BENCH_DIR
from .corpus import Texts, rows_on_device
from .weights import make_weights, role_seed


@dataclass
class Record:
    """One message as the timed path answered it."""

    text: str
    sources: list = field(default_factory=list)  # [(node id, score)]
    candidates: list | None = None  # [(node id, dot)] handed to the reranker


def load_reference(config: dict):
    path = BENCH_DIR / "configs" / f"{config['reference']}.py"
    spec = importlib.util.spec_from_file_location(f"bench_reference_{config['reference']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample(records: list[Record], seed: int, n: int, n_tokens) -> list[Record]:
    """``n`` records drawn from ``seed``, the one with the longest query
    first among them."""
    if len(records) <= n:
        return list(records)
    longest = max(range(len(records)), key=lambda i: (n_tokens(records[i].text), -i))
    rest = [i for i in range(len(records)) if i != longest]
    picked = random.Random(seed).sample(rest, n - 1)
    return [records[longest]] + [records[i] for i in sorted(picked)]


class Reference:
    """The configuration's reference at one precision, its weights rebuilt
    from the run's seed."""

    def __init__(self, config: dict, seed: int, device, precision: str = "fp32"):
        import torch

        self.ref = load_reference(config)
        self.ref.fp32_mode()
        self.config, self.device, self.precision = config, device, precision
        self.texts = Texts(config["corpus"])
        self.emb = self.ref.XLMR(config["embedder"], make_weights(
            config["embedder"], role_seed(seed, "embedder"), device, torch.float32), precision)
        self.rr = self.ref.XLMR(config["reranker"], make_weights(
            config["reranker"], role_seed(seed, "reranker"), device, torch.float32), precision)

    def embed(self, texts):
        import torch

        with torch.no_grad():
            return self.emb.embed(texts, self.device)

    def scores(self, pairs, block: int = 256):
        import torch

        out = []
        with torch.no_grad():
            for a in range(0, len(pairs), block):
                out.append(self.rr.scores(pairs[a: a + block], self.device))
        return torch.cat(out) if out else torch.zeros(0)

    def search(self, q, k: int, extra_rows: list[list[int]] | None = None):
        """Exact top ``k`` (dots, leaf rows) per query, and the dots at each
        query's ``extra_rows``."""
        import torch

        corpus = self.config["corpus"]
        best_v = torch.full((q.shape[0], k), -math.inf, device=self.device)
        best_i = torch.full((q.shape[0], k), -1, dtype=torch.long, device=self.device)
        want = extra_rows or [[] for _ in range(q.shape[0])]
        at = [dict() for _ in range(q.shape[0])]
        with torch.no_grad():
            for a, dots in self.ref.search_dots(q, rows_on_device(corpus, self.device), self.precision):
                n = dots.shape[1]
                v, i = torch.topk(dots, min(k, n), dim=1)
                cat_v, cat_i = torch.cat([best_v, v], 1), torch.cat([best_i, i + a], 1)
                best_v, pos = torch.topk(cat_v, k, dim=1)
                best_i = torch.gather(cat_i, 1, pos)
                for r, rows in enumerate(want):
                    for j in rows:
                        if a <= j < a + n:
                            at[r][j] = float(dots[r, j - a])
        return best_v.cpu(), best_i.cpu(), at


def _leaf_row(node_id: str) -> int | None:
    return int(node_id[1:]) if node_id.startswith("n") else None


def compare(records: list[Record], ref: Reference, exact_search: bool) -> tuple[dict, dict]:
    """(numbers compared, what else was seen) for ``records``."""
    serving = ref.config["serving"]
    k, top_n, hard = serving["similarity_top_k"], serving["reranker_top_n"], serving["confidence_cutoff_hard"]
    q = ref.embed([r.text for r in records])
    cand_rows = [[j for j in (_leaf_row(c) for c, _ in (r.candidates or [])) if j is not None] for r in records]
    top_v, top_i, at = ref.search(q, k, cand_rows)

    pairs, where = [], {}
    for m, r in enumerate(records):
        for nid in dict.fromkeys([c for c, _ in (r.candidates or [])] + [s for s, _ in r.sources]):
            where[(m, nid)] = len(pairs)
            pairs.append((r.text, ref.texts.of_node(nid)))
    ref_scores = ref.scores(pairs).cpu().tolist()

    dot_gap = rank_gap = score_gap = sel_gap = 0.0
    faults = 0
    seen = {"messages": len(records), "candidates": 0, "merged": 0, "sources": 0, "recall_at_k": 0.0}
    for m, r in enumerate(records):
        cands = r.candidates or []
        leaf_dots = [(j, d) for c, d in cands if (j := _leaf_row(c)) is not None]
        seen["candidates"] += len(cands)
        seen["merged"] += len(cands) - len(leaf_dots)
        for j, d in leaf_dots:
            dot_gap = max(dot_gap, abs(d - at[m][j]))
        kth = float(top_v[m, -1])
        if len(leaf_dots) == len(cands):  # no merge: k leaves are due
            weakest = min(at[m][j] for j, _ in leaf_dots) if len(leaf_dots) >= k else -1.0
            rank_gap = max(rank_gap, kth - weakest)
        exact = set(int(i) for i in top_i[m])
        seen["recall_at_k"] += len(exact & {j for j, _ in leaf_dots}) / k / len(records)

        mine = {nid: ref_scores[where[(m, nid)]] for nid in dict.fromkeys([c for c, _ in cands])}
        best = sorted(mine.values(), reverse=True)
        expected = min(top_n, sum(s >= hard for s in best))
        ids = [nid for nid, _ in r.sources]
        seen["sources"] += len(ids)
        faults += max(0, len(ids) - top_n) + sum(nid not in mine for nid in ids) + len(ids) - len(set(ids))
        for i, (nid, score) in enumerate(r.sources):
            rs = ref_scores[where[(m, nid)]]
            score_gap = max(score_gap, abs(score - rs))
            sel_gap = max(sel_gap, hard - rs, best[i] - rs if i < len(best) else 0.0)
        for i in range(len(ids), expected):
            sel_gap = max(sel_gap, best[i] - hard)
    numbers = {"search_dot_gap": dot_gap, "rerank_score_gap": score_gap, "selection_gap": sel_gap,
               "selection_faults": float(faults)}
    if exact_search:
        numbers["search_rank_gap"] = max(rank_gap, 0.0)
    else:
        seen["search_rank_gap"] = max(rank_gap, 0.0)
    return numbers, seen


def control_records(texts: list[str], ctrl: Reference, order: str = "desc") -> list[Record]:
    """The served path's answers, computed by ``ctrl`` at its precision:
    exact top k, auto-merge (more than ``merge_ratio`` of a parent's leaves
    present), rerank, the top n by ``order``, the hard cutoff."""
    serving = ctrl.config["serving"]
    k, top_n, hard = serving["similarity_top_k"], serving["reranker_top_n"], serving["confidence_cutoff_hard"]
    per = ctrl.config["corpus"]["leaves_per_parent"]
    n = ctrl.config["corpus"]["n_leaves"]
    q = ctrl.embed(texts)
    top_v, top_i, _ = ctrl.search(q, k)
    records = []
    for m, text in enumerate(texts):
        hits = [(f"n{int(j):08d}", float(v)) for v, j in zip(top_v[m], top_i[m]) if int(j) >= 0]
        by_parent: dict[int, list] = {}
        for nid, v in hits:
            by_parent.setdefault(int(nid[1:]) // per, []).append((nid, v))
        cands = []
        for p, kids in by_parent.items():
            n_kids = min(per, n - p * per)
            if len(kids) / n_kids > serving.get("merge_ratio", 0.5):
                cands.append((f"p{p:08d}", sum(v for _, v in kids) / len(kids)))
            else:
                cands.extend(kids)
        cands.sort(key=lambda c: -c[1])
        records.append(Record(text, candidates=cands))
    pairs = [(r.text, ctrl.texts.of_node(c)) for r in records for c, _ in r.candidates]
    scores = ctrl.scores(pairs).cpu().tolist()
    at = 0
    for r in records:
        s = scores[at: at + len(r.candidates)]
        at += len(r.candidates)
        ranked = sorted(zip([c for c, _ in r.candidates], s), key=lambda x: x[1] if order == "ascending" else -x[1])
        ranked = ranked[:top_n][::-1] if order == "reverse" else ranked[:top_n]
        r.sources = [(c, v) for c, v in ranked if v >= hard]
    return records


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, name -> {value, limit})."""
    shown = {name: {"value": numbers[name], "limit": limits.get(name)} for name in numbers}
    ok = bool(limits) and all(name in limits and numbers[name] <= limits[name] for name in numbers)
    return ok, shown


def print_checks(shown: dict) -> None:
    for name, v in shown.items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
