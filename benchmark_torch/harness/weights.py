"""Model weights from ``--seed``, made on the device in the served dtype.

One normal draw fills a flat bf16 buffer with every dense weight, bias and
table (N(0, 0.02), or the model's ``init_std``); a second fills the LayerNorm gains (1 + N(0, 0.02)) and
shifts (N(0, 0.02)). The tensors are views of the buffers under the Hugging
Face names of ``XLMRobertaModel`` / ``XLMRobertaForSequenceClassification``,
which the program loads through its own checkpoint converter and the plain
reference reads directly.
"""

from __future__ import annotations

ROLE_SALT = {"embedder": 0x3C6EF372, "reranker": 0x5BE0CD19}


def role_seed(seed: int, role: str) -> int:
    return (int(seed) * 2654435761 + ROLE_SALT[role]) % (1 << 63)


def shapes(m: dict) -> tuple[list[tuple[str, tuple]], list[tuple[str, tuple]]]:
    """(dense weights, biases and tables; LayerNorm parameters) of the model
    ``m`` (a configuration's ``embedder`` or ``reranker`` entry)."""
    h, i = m["hidden_size"], m["intermediate_size"]
    dense = [
        ("embeddings.word_embeddings.weight", (m["vocab_size"], h)),
        ("embeddings.position_embeddings.weight", (m["max_position_embeddings"], h)),
        ("embeddings.token_type_embeddings.weight", (m["type_vocab_size"], h)),
    ]
    norms = [("embeddings.LayerNorm", (h,))]
    for layer in range(m["num_hidden_layers"]):
        p = f"encoder.layer.{layer}."
        for name, n_out, n_in in (
            ("attention.self.query", h, h), ("attention.self.key", h, h), ("attention.self.value", h, h),
            ("attention.output.dense", h, h), ("intermediate.dense", i, h), ("output.dense", h, i),
        ):
            dense += [(p + name + ".weight", (n_out, n_in)), (p + name + ".bias", (n_out,))]
        norms += [(p + "attention.output.LayerNorm", (h,)), (p + "output.LayerNorm", (h,))]
    if m.get("num_labels"):
        dense += [
            ("classifier.dense.weight", (h, h)), ("classifier.dense.bias", (h,)),
            ("classifier.out_proj.weight", (m["num_labels"], h)), ("classifier.out_proj.bias", (m["num_labels"],)),
        ]
    return dense, norms


def make_weights(m: dict, seed: int, device, dtype=None) -> dict:
    """name -> tensor on ``device`` (bf16 unless ``dtype``), drawn from
    ``seed`` in two large calls."""
    import math

    import torch

    dtype = dtype or torch.bfloat16
    dense, norms = shapes(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for _, s in dense]
    std = m.get("init_std", 0.02)
    flat = torch.empty(sum(sizes), dtype=torch.bfloat16, device=device).normal_(0.0, std, generator=gen)
    h = norms[0][1][0]
    ln = torch.empty(2 * len(norms) * h, dtype=torch.bfloat16, device=device).normal_(0.0, 0.02, generator=gen)
    out, at = {}, 0
    for (name, shape), n in zip(dense, sizes):
        out[name] = flat[at: at + n].view(shape)
        at += n
    ln = ln.view(len(norms), 2, h)
    ln[:, 0] += 1.0
    for k, (name, _) in enumerate(norms):
        out[name + ".weight"], out[name + ".bias"] = ln[k, 0], ln[k, 1]
    if dtype != torch.bfloat16:
        out = {k: v.to(dtype) for k, v in out.items()}
    return out


def n_params(m: dict) -> int:
    import math

    dense, norms = shapes(m)
    return sum(math.prod(s) for _, s in dense) + 2 * sum(s[0] for _, s in norms)
