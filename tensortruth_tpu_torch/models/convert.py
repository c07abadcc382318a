"""Local HF checkpoint -> :class:`XLMRModel`, offline only.

Port of ``tensortruth_tpu/models/convert.py``. Two HF families share the
``encoder.layer.{i}.*`` layout and both load:

* ``XLMRobertaModel`` / ``XLMRobertaForSequenceClassification`` (BGE-M3,
  bge-reranker-v2-m3);
* ``BertModel`` / ``BertForSequenceClassification`` (MiniLM-class models).

The port keeps torch's (out, in) Linear layout, so the mapping is a renaming:
no transposes, no stacking. Roberta's ``classifier.dense -> out_proj`` and
BERT's ``pooler.dense -> classifier`` are the same computation and map onto
the one ``classifier`` head.
"""

from __future__ import annotations

import json
import os

import torch

from tensortruth_tpu_torch.models.xlmr import XLMRConfig, XLMRModel

_LAYER_KEYS = {
    "q.weight": "attention.self.query.weight",
    "q.bias": "attention.self.query.bias",
    "k.weight": "attention.self.key.weight",
    "k.bias": "attention.self.key.bias",
    "v.weight": "attention.self.value.weight",
    "v.bias": "attention.self.value.bias",
    "o.weight": "attention.output.dense.weight",
    "o.bias": "attention.output.dense.bias",
    "ln1.weight": "attention.output.LayerNorm.weight",
    "ln1.bias": "attention.output.LayerNorm.bias",
    "fc1.weight": "intermediate.dense.weight",
    "fc1.bias": "intermediate.dense.bias",
    "fc2.weight": "output.dense.weight",
    "fc2.bias": "output.dense.bias",
    "ln2.weight": "output.LayerNorm.weight",
    "ln2.bias": "output.LayerNorm.bias",
}


def _tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def state_dict_from_hf(sd: dict, num_layers: int, num_labels: int = 0) -> dict[str, torch.Tensor]:
    """Rename an HF encoder state dict into :class:`XLMRModel` keys. Accepts
    key prefixes ``""``, ``"roberta."``, ``"bert."`` and ``"model."``."""
    prefix = ""
    for p in ("roberta.", "bert.", "model.", ""):
        if any(k.startswith(p + "embeddings.word_embeddings") for k in sd):
            prefix = p
            break

    def get(name):
        return _tensor(sd[prefix + name])

    out = {
        "word": get("embeddings.word_embeddings.weight"),
        "position": get("embeddings.position_embeddings.weight"),
        "token_type": get("embeddings.token_type_embeddings.weight"),
        "ln.weight": get("embeddings.LayerNorm.weight"),
        "ln.bias": get("embeddings.LayerNorm.bias"),
    }
    for i in range(num_layers):
        for ours, theirs in _LAYER_KEYS.items():
            out[f"layers.{i}.{ours}"] = get(f"encoder.layer.{i}.{theirs}")
    if num_labels:
        if "classifier.dense.weight" in sd:  # RobertaClassificationHead
            head = {
                "dense": ("classifier.dense.weight", "classifier.dense.bias"),
                "out": ("classifier.out_proj.weight", "classifier.out_proj.bias"),
            }
        else:  # BertForSequenceClassification: pooler.dense -> classifier
            head = {
                "dense": (prefix + "pooler.dense.weight", prefix + "pooler.dense.bias"),
                "out": ("classifier.weight", "classifier.bias"),
            }
        for ours, (w, b) in head.items():
            out[f"classifier.{ours}.weight"] = _tensor(sd[w])
            out[f"classifier.{ours}.bias"] = _tensor(sd[b])
    return out


def config_from_hf(model_dir: str, num_labels: int = 0) -> XLMRConfig | None:
    """:class:`XLMRConfig` from a checkpoint's ``config.json`` (and, for
    sentence-transformers embedders, ``1_Pooling/config.json``). None when
    the file is absent or names an unsupported ``model_type``."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        hf = json.load(f)

    model_type = hf.get("model_type", "")
    if model_type == "bert":
        position_style = "bert"
    elif model_type in ("xlm-roberta", "roberta", "camembert"):
        position_style = "xlmr"
    else:
        return None

    pooling = "cls"
    pool_path = os.path.join(model_dir, "1_Pooling", "config.json")
    if num_labels == 0 and os.path.exists(pool_path):
        try:
            with open(pool_path, encoding="utf-8") as f:
                if json.load(f).get("pooling_mode_mean_tokens"):
                    pooling = "mean"
        except (OSError, ValueError):
            pass

    return XLMRConfig(
        vocab_size=hf.get("vocab_size", 250002),
        hidden_size=hf.get("hidden_size", 1024),
        num_layers=hf.get("num_hidden_layers", 24),
        num_heads=hf.get("num_attention_heads", 16),
        intermediate_size=hf.get("intermediate_size", 4096),
        max_position=hf.get("max_position_embeddings", 8194),
        type_vocab_size=hf.get("type_vocab_size", 1),
        pad_token_id=hf.get("pad_token_id", 1 if position_style == "xlmr" else 0),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
        num_labels=num_labels,
        position_style=position_style,
        pooling=pooling,
    )


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read a local .safetensors file into a flat name -> CPU tensor dict."""
    from safetensors.torch import load_file

    return load_file(path)


def read_local_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """``model.safetensors``, a sharded safetensors index, or
    ``pytorch_model.bin``, in that order."""
    st = os.path.join(model_dir, "model.safetensors")
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(st):
        return load_safetensors(st)
    if os.path.exists(index):
        with open(index, encoding="utf-8") as f:
            weight_map = json.load(f)["weight_map"]
        sd = {}
        for shard in sorted(set(weight_map.values())):
            sd.update(load_safetensors(os.path.join(model_dir, shard)))
        return sd
    pt = os.path.join(model_dir, "pytorch_model.bin")
    return torch.load(pt, map_location="cpu", weights_only=True)


def load_local_checkpoint(
    model_dir: str, cfg: XLMRConfig, device, dtype=torch.bfloat16
) -> XLMRModel:
    """A local HF model directory -> :class:`XLMRModel` on ``device``."""
    sd = state_dict_from_hf(
        read_local_state_dict(model_dir), num_layers=cfg.num_layers, num_labels=cfg.num_labels
    )
    return XLMRModel.from_state_dict(cfg, sd, device=device, dtype=dtype)
