"""Cross-encoder reranker runtime (bge-reranker-v2-m3 architecture).

Port of ``tensortruth_tpu/models/reranker.py``: each (query, doc) pair is one
forward through the XLM-R cross-encoder, and a sigmoid maps logits into
[0, 1], the scale of the confidence cutoffs (0.35 soft / 0.05 hard).

Pairs are tokenized once, sorted longest first, cut into runs that never mix
sequence buckets, and each run splits greedily into exact batch-bucket sizes
(208 -> 128 + 64 + 16); buckets of 320 tokens and up cap the batch at 64
rows. The buckets and the cap are the reference's, tuned on a TPU and not
yet re-measured on the H100.

``score_pairs_async`` keeps the two-phase contract that
``services/batcher.py`` relies on: every batch is launched now, its token
ids uploaded without a stream synchronise (``embedder.upload``), the scores
are concatenated on the device and copied to pinned host memory behind a
CUDA event, and ``finish()`` waits only for that event.

On a mesh (``Reranker(mesh=...)``) every forward is data-parallel over the
mesh's slots (``embedder.make_dp_forward``), with type ids as a third batch
array for the models that need them; batches round up to a multiple of the
mesh size.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tensortruth_tpu_torch.models.embedder import bucket, make_dp_forward, pad_batch, to_host_async
from tensortruth_tpu_torch.models.xlmr import XLMRConfig, XLMRModel, rerank_logits
from tensortruth_tpu_torch.utils import profiling


class Reranker:
    def __init__(
        self,
        model: XLMRModel,
        tokenizer,
        max_length: int = 2048,
        batch_buckets: Sequence[int] = (16, 32, 64, 128),
        seq_buckets: Sequence[int] = (64, 128, 192, 256, 320, 512, 1024, 2048),
        mesh=None,
    ):
        cfg = model.cfg
        if cfg.num_labels != 1:
            raise ValueError("reranker config needs num_labels=1")
        self.model = model
        self.cfg: XLMRConfig = cfg
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.seq_buckets = tuple(sorted(set(min(b, max_length) for b in seq_buckets)))
        # BERT-family cross-encoders were trained with segment ids on the doc
        # side; XLM-R rerankers have a single token type.
        self._needs_type_ids = cfg.position_style == "bert" and cfg.type_vocab_size > 1
        self.mesh = mesh
        self._fwd, self._batch_multiple = make_dp_forward(rerank_logits, model, mesh)

    @classmethod
    def random_init(
        cls, cfg: XLMRConfig, tokenizer, device, dtype=torch.bfloat16, seed: int = 0, **kw
    ) -> "Reranker":
        return cls(XLMRModel.random_init(cfg, device, dtype=dtype, seed=seed), tokenizer, **kw)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def param_bytes(self) -> int:
        return self.model.param_bytes()

    def score(self, query: str, docs: Sequence[str]) -> np.ndarray:
        """Sigmoid relevance scores in [0, 1], shape (len(docs),) f32."""
        return self.score_pairs([(query, d) for d in docs])

    def rerank(self, query: str, docs: Sequence[str], top_n: int) -> tuple[np.ndarray, np.ndarray]:
        """(order, scores): indices of the top_n docs by score, descending."""
        scores = self.score(query, docs)
        order = np.argsort(-scores, kind="stable")[:top_n]
        return order, scores

    def score_pairs(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        """[(query, doc), ...] -> (N,) sigmoid scores."""
        return self.score_pairs_async(pairs)()

    def score_pairs_async(self, pairs: Sequence[tuple[str, str]], feeder=None):
        """Launch every device batch now; return ``finish() -> (N,) f32``.

        ``feeder`` (services/feeder.py HostFeeder) shards the tokenize stage
        over a worker pool; None tokenizes in this thread."""
        if not pairs:
            return lambda: np.zeros((0,), dtype=np.float32)
        if feeder is not None:
            ids, mask = feeder.tokenize_pairs(self.tokenizer, pairs, self.max_length)
        else:
            ids, mask = self.tokenizer.encode_batch(
                [q for q, _ in pairs], self.max_length, pair=[d for _, d in pairs]
            )
        return self.score_tokenized_async(ids, mask)

    def _groups(self, lengths: np.ndarray) -> list[np.ndarray]:
        """Seq-bucket-pure runs of the longest-first order, each split
        greedily into exact batch-bucket sizes."""
        order = np.argsort(-lengths, kind="stable")
        groups: list[np.ndarray] = []

        def split_run(run: np.ndarray, seq_bucket: int) -> None:
            cap = 64 if seq_bucket >= 320 else self.batch_buckets[-1]
            usable = [b for b in self.batch_buckets if b <= cap] or list(self.batch_buckets[:1])
            i = 0
            while i < len(run):
                rem = len(run) - i
                take = next((b for b in reversed(usable) if b <= rem), rem)
                groups.append(run[i : i + take])
                i += take

        run_start = 0
        run_bucket = bucket(int(lengths[order[0]]), self.seq_buckets)
        for i in range(1, len(order) + 1):
            b_i = bucket(int(lengths[order[i]]), self.seq_buckets) if i < len(order) else None
            if b_i != run_bucket:
                split_run(order[run_start:i], run_bucket)
                run_start, run_bucket = i, b_i
        return groups

    def score_tokenized_async(self, ids: np.ndarray, mask: np.ndarray):
        """Bucket, pad and launch over pre-tokenized pair rows."""
        n_pairs = ids.shape[0]
        if n_pairs == 0:
            return lambda: np.zeros((0,), dtype=np.float32)
        lengths = mask.sum(axis=1)
        sels, probs = [], []
        # tokens: the pairs' own; slots: the padded rows the forwards take
        with profiling.span("rerank.launch", pairs=n_pairs) as span, torch.inference_mode():
            for sel in self._groups(lengths):
                seq = bucket(int(lengths[sel].max()), self.seq_buckets)
                bsz = bucket(len(sel), self.batch_buckets)
                bsz = -(-bsz // self._batch_multiple) * self._batch_multiple  # DP
                if span:
                    span.count(forwards=1, tokens=int(lengths[sel].sum()), slots=bsz * seq)
                batch = pad_batch(ids, mask, sel, bsz, seq, self.tokenizer.pad_id)
                if self._needs_type_ids:
                    # type 1 strictly after the first [SEP], 0 elsewhere incl. padding
                    ids_p, mask_p = batch
                    first_sep = (ids_p == self.tokenizer.sep_id).argmax(axis=1)
                    batch += (((np.arange(seq)[None, :] > first_sep[:, None]) & (mask_p > 0)).astype(np.int32),)
                logits = self._fwd(*batch)
                probs.append(torch.sigmoid(logits[: len(sel)]))
                sels.append(sel)
            wait = to_host_async(torch.cat(probs))
        order = np.concatenate(sels)

        def finish() -> np.ndarray:
            with profiling.span("rerank.finish", pairs=n_pairs):
                out = np.empty((n_pairs,), dtype=np.float32)
                out[order] = wait()
            return out

        return finish
