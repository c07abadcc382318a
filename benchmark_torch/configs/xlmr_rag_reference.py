"""Plain float32 reference of the XLM-R retrieval path (BGE-M3 embedder,
bge-reranker-v2-m3 cross-encoder, dense search over unit rows).

Plain ``torch`` operations only: no kernel, cache or batching of the port,
and nothing of the port imported. Follows XLM-RoBERTa large as published
(post-LN blocks, exact GELU, CLS pooling; the cross-encoder's head is dense
-> tanh -> out_proj, then a sigmoid), with two departures that follow the
served configuration: the offline hash tokenizer (copied below; the repo
has no ``tokenizer.json``), whose pad id is 0, so positions come from the
attention mask (``cumsum(mask) * mask + 1``) rather than from the ids; and
padded keys take an additive -1e9 before the softmax.

``precision="fp32"`` computes every product in float32 with TF32 off.
``precision="fp8"`` is the control: every matrix product's operands (the
dense layers' inputs and weights, attention's q, k, probabilities and v,
the search's query and rows) rounded to float8 e4m3 with one scale per
tensor (per row for the corpus), products accumulated in float32.
"""

from __future__ import annotations

import hashlib
import math
import re

import torch

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)
VOCAB, N_SPECIAL, PAD, CLS, SEP = 250002, 5, 0, 1, 2
E4M3_MAX = 448.0


def tokens(text: str) -> list[int]:
    """The offline tokenizer: words and punctuation, each a stable hash."""
    out = []
    for w in _WORD_RE.findall(text):
        h = hashlib.blake2b(w.lower().encode("utf-8"), digest_size=8).digest()
        out.append(N_SPECIAL + int.from_bytes(h, "little") % (VOCAB - N_SPECIAL))
    return out


def n_tokens(text: str) -> int:
    return len(_WORD_RE.findall(text))


def sequence(a: str, b: str | None = None, max_length: int = 2048) -> list[int]:
    """<s> a </s>, or <s> a </s></s> b </s> with the query given up to half
    of the budget, cut to ``max_length``."""
    ta = tokens(a)
    if b is None:
        return [CLS] + ta[: max_length - 2] + [SEP]
    a_budget = min(len(ta), max(1, (max_length - 4) // 2))
    seq = [CLS] + ta[:a_budget] + [SEP, SEP] + tokens(b)[: max_length - 4 - a_budget] + [SEP]
    return seq[:max_length]


def fp32_mode() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (or per ``dim``)."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    s = E4M3_MAX / amax.clamp(min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class XLMR:
    """One encoder (embedder or cross-encoder) over float32 weights given
    under the Hugging Face names."""

    def __init__(self, m: dict, weights: dict, precision: str = "fp32"):
        self.m, self.w, self.fp8 = m, weights, precision == "fp8"
        self.vocab = m["vocab_size"]
        self.max_length = min(m["max_length"], m["max_position_embeddings"] - 2)

    def _p(self, x):
        return q8(x) if self.fp8 else x

    def _dense(self, x, name):
        return self._p(x) @ self._p(self.w[name + ".weight"]).T + self.w[name + ".bias"]

    def _ln(self, x, name):
        return torch.nn.functional.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"],
                                              self.m["layer_norm_eps"])

    def hidden(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m, w = self.m, self.w
        b, s = ids.shape
        nh = m["num_attention_heads"]
        dh = m["hidden_size"] // nh
        pos = torch.cumsum(mask, dim=1) * mask + 1
        ids = ids.clamp(max=self.vocab - 1)  # a model narrower than the tokenizer takes its last row
        x = (w["embeddings.word_embeddings.weight"][ids] + w["embeddings.position_embeddings.weight"][pos]
             + w["embeddings.token_type_embeddings.weight"][0])
        x = self._ln(x, "embeddings.LayerNorm")
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        for layer in range(m["num_hidden_layers"]):
            p = f"encoder.layer.{layer}."

            def heads(y):
                return y.view(b, s, nh, dh).transpose(1, 2)

            q = heads(self._dense(x, p + "attention.self.query"))
            k = heads(self._dense(x, p + "attention.self.key"))
            v = heads(self._dense(x, p + "attention.self.value"))
            scores = self._p(q) @ self._p(k).transpose(-1, -2) / math.sqrt(dh) + bias
            ctx = self._p(torch.softmax(scores, dim=-1)) @ self._p(v)
            ctx = ctx.transpose(1, 2).reshape(b, s, -1)
            x = self._ln(x + self._dense(ctx, p + "attention.output.dense"), p + "attention.output.LayerNorm")
            f = torch.nn.functional.gelu(self._dense(x, p + "intermediate.dense"))
            x = self._ln(x + self._dense(f, p + "output.dense"), p + "output.LayerNorm")
        return x

    def run(self, seqs: list[list[int]], device, block: int = 16):
        """CLS states of token sequences, in blocks of rows padded to the
        block's longest."""
        order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
        out = [None] * len(seqs)
        for a in range(0, len(order), block):
            sel = order[a: a + block]
            s = max(len(seqs[i]) for i in sel)
            ids = torch.full((len(sel), s), PAD, dtype=torch.long)
            mask = torch.zeros((len(sel), s), dtype=torch.long)
            for r, i in enumerate(sel):
                ids[r, : len(seqs[i])] = torch.tensor(seqs[i])
                mask[r, : len(seqs[i])] = 1
            cls = self.hidden(ids.to(device), mask.to(device))[:, 0, :]
            for r, i in enumerate(sel):
                out[i] = cls[r]
        return torch.stack(out)

    def embed(self, texts: list[str], device) -> torch.Tensor:
        """Unit CLS embeddings (B, H)."""
        cls = self.run([sequence(t, max_length=self.max_length) for t in texts], device)
        return cls / torch.linalg.vector_norm(cls, dim=-1, keepdim=True)

    def scores(self, pairs: list[tuple[str, str]], device) -> torch.Tensor:
        """Sigmoid relevance of each (query, passage) pair (B,)."""
        cls = self.run([sequence(a, b, self.max_length) for a, b in pairs], device)
        h = torch.tanh(self._dense(cls, "classifier.dense"))
        return torch.sigmoid(self._dense(h, "classifier.out_proj")[:, 0])


def search_dots(q: torch.Tensor, rows_chunks, precision: str = "fp32"):
    """Yield (first row, q . rows) over bf16 row chunks, in float32 (the
    control: both sides rounded to e4m3, the rows with a scale per row)."""
    qq = q8(q, dim=-1) if precision == "fp8" else q
    for a, rows in rows_chunks:
        r = rows.float()
        if precision == "fp8":
            r = q8(r, dim=-1)
        yield a, qq @ r.T
