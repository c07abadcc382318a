"""The XLM-R family: BGE-M3 (``XLMRobertaModel``) and bge-reranker-v2-m3
(``XLMRobertaForSequenceClassification``).

Everything the harness knows of this architecture, found through
``harness/families.py`` by the role entry's ``architectures``: the weights'
Hugging Face names and shapes, how the program is seated with them, the
forward operation count, the token template, the tiny sizes of a CPU
rehearsal, and its class in the plain reference.
"""

from __future__ import annotations

ARCHITECTURES = ("XLMRobertaModel", "XLMRobertaForSequenceClassification")
# Its class in the plain reference: (file under ``configs/``, class name).
REFERENCE = ("xlmr_rag_reference", "XLMR")
# A LayerNorm's parameters, in draw order (``harness/weights.py``): the gain, then the shift.
NORM_PARAMS = ("weight", "bias")

# The port's test models (``models/manager.py``'s ``tiny-*`` ids); weights
# wider than N(0, 0.02) so that scores of different passages differ at this
# width as they do at full width.
_TINY = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 128, "max_position_embeddings": 130, "init_std": 0.2}
TINY = {"embedder": dict(_TINY, model_id="tiny-embedder"), "reranker": dict(_TINY, model_id="tiny-reranker")}


def shapes(m: dict) -> tuple[list[tuple[str, tuple]], list[tuple[str, tuple]]]:
    """(dense weights, biases and tables; LayerNorms) of the model ``m`` (a
    configuration's ``embedder`` or ``reranker`` entry), in draw order."""
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


def flops(m: dict, seq_lens) -> float:
    """Forward operations over sequences of the given real (unpadded)
    lengths: per layer and token the four projections (8 H^2) and the two
    FFN products (4 H I), per layer and sequence the scores and context
    products (4 S^2 H); a classification head adds 2 H^2 + 2 H labels per
    sequence."""
    h, i, layers = m["hidden_size"], m["intermediate_size"], m["num_hidden_layers"]
    per_token = layers * (8 * h * h + 4 * h * i)
    total = 0.0
    for s in seq_lens:
        total += s * per_token + layers * 4 * s * s * h
    if m.get("num_labels"):
        total += len(seq_lens) * (2 * h * h + 2 * h * m["num_labels"])
    return total


def seq_len(n_a: int, n_b: int | None, max_length: int) -> int:
    """Tokens of <s> a </s> or <s> a </s></s> b </s> as the tokenizer cuts
    them to ``max_length`` (the query given up to half)."""
    if n_b is None:
        return min(n_a, max_length - 2) + 2
    a = min(n_a, max(1, (max_length - 4) // 2))
    return min(max_length, a + min(n_b, max_length - 4 - a) + 4)


def check_program(m: dict, role: str, cfg) -> None:
    """Raise unless the model the program serves in ``role`` (its
    ``XLMRConfig``) has the sizes the configuration states."""
    want = (m["vocab_size"], m["hidden_size"], m["num_hidden_layers"], m["num_attention_heads"],
            m["intermediate_size"], m["max_position_embeddings"], m["num_labels"])
    got = (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.intermediate_size,
           cfg.max_position, cfg.num_labels)
    if want != got:
        raise RuntimeError(f"the program serves {role} {got}, the configuration states {want}")


def program_state(cfg, weights: dict) -> dict:
    """The program's state dict of ``weights`` (Hugging Face names), by the
    program's own checkpoint converter."""
    from tensortruth_tpu_torch.models.convert import state_dict_from_hf

    return state_dict_from_hf(weights, num_layers=cfg.num_layers, num_labels=cfg.num_labels)


def program_model(cfg, weights: dict, device, dtype):
    """The program's model of ``cfg`` holding ``weights``."""
    from tensortruth_tpu_torch.models.xlmr import XLMRModel

    return XLMRModel.from_state_dict(cfg, program_state(cfg, weights), device=device, dtype=dtype)
