"""XLM-RoBERTa encoder in PyTorch: the shared backbone of the BGE-M3 embedder
and the bge-reranker-v2-m3 cross-encoder.

Port of ``tensortruth_tpu/models/xlmr.py``, with the same numerics:

* post-LN BERT blocks; LayerNorm computed in f32 and cast back;
* every dense layer accumulates in f32 and adds its bias in f32 before one
  rounding to the activation dtype: ``addmm`` with the bias as its input,
  which cuBLAS adds in the f32 epilogue of the product (strictly f32 when
  ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
  False, as ``chip_smoke.py`` sets it);
* GELU and tanh evaluated in f32 and rounded once (PyTorch computes them in
  f32 for bf16 inputs);
* an additive -1e9 padding bias (not -inf), so a fully padded row stays
  finite;
* XLM-R position ids ``cumsum(mask) * mask + pad_id`` or BERT's ``arange``;
* exact (erf) GELU unless ``approx_gelu`` asks for the tanh form;
* attention through kernel B3 (``ops/attention.py``) on CUDA at S >= 512
  with S % 256 == 0, plain PyTorch below that, as the reference routes
  between its Pallas kernel and XLA.

Parameters live in ``nn.Module``s. Dense weights are (out, in), the
``torch.nn.Linear`` layout, so HF checkpoints load without transposes;
:func:`params_from_jax` transposes the reference's stacked (L, in, out)
pytree into this layout. No autograd: the engine only serves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tensortruth_tpu_torch.ops.matmul import bmm_f32


@dataclass(frozen=True)
class XLMRConfig:
    vocab_size: int = 250002
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 8194  # includes the +2 padding_idx offset
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    num_labels: int = 0  # classification head (reranker only)
    # Kernel B3: None = auto (CUDA and S >= 512), True/False forces it
    # (still only where S % 256 == 0).
    flash_attention: bool | None = None
    # GELU flavour: None/False = exact erf, True = tanh approximation (the
    # reference's TPU default; indexes built there record gelu: tanh).
    approx_gelu: bool | None = None
    position_style: str = "xlmr"  # "xlmr" (cumsum + pad id) or "bert" (arange)
    pooling: str = "cls"  # "cls" (BGE family) or "mean"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BGE_M3_CONFIG = XLMRConfig()
BGE_RERANKER_V2_M3_CONFIG = XLMRConfig(num_labels=1)


def use_flash(cfg: XLMRConfig, s: int, device: torch.device) -> bool:
    if cfg.flash_attention is not None:
        return cfg.flash_attention and s % 256 == 0
    return device.type == "cuda" and s >= 512 and s % 256 == 0


def use_approx_gelu(cfg: XLMRConfig) -> bool:
    return bool(cfg.approx_gelu)


class LayerNorm32(nn.Module):
    """LayerNorm over the last axis in f32 (f32 params), cast back to x.dtype."""

    def __init__(self, h: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(h, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(h, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.nn.functional.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Dense(nn.Module):
    """y = x W^T + b with f32 accumulation and f32 bias add, one rounding."""

    def __init__(self, n_in: int, n_out: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(n_out, device=device, dtype=dtype), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.addmm(self.bias, x.reshape(-1, x.shape[-1]), self.weight.t())
        return y.view(*x.shape[:-1], -1)


class XLMRLayer(nn.Module):
    """One post-LN block: attention -> add & LN -> FFN -> add & LN."""

    def __init__(self, cfg: XLMRConfig, device=None, dtype=None):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.q = Dense(h, h, device, dtype)
        self.k = Dense(h, h, device, dtype)
        self.v = Dense(h, h, device, dtype)
        self.o = Dense(h, h, device, dtype)
        self.ln1 = LayerNorm32(h, cfg.layer_norm_eps, device)
        self.fc1 = Dense(h, i, device, dtype)
        self.fc2 = Dense(i, h, device, dtype)
        self.ln2 = LayerNorm32(h, cfg.layer_norm_eps, device)

    def attention(self, x: torch.Tensor, mask: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, h = x.shape
        nh, dh = cfg.num_heads, cfg.head_dim

        def split(y):
            return y.view(b, s, nh, dh).transpose(1, 2)  # (B, NH, S, DH) view

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if use_flash(cfg, s, x.device):
            from tensortruth_tpu_torch.ops.attention import blocked_attention

            ctx = blocked_attention(q, k, v, mask)
        else:
            scores = bmm_f32(
                q.reshape(b * nh, s, dh), k.reshape(b * nh, s, dh).transpose(1, 2)
            ).view(b, nh, s, s)
            scores = scores / math.sqrt(dh) + mask_bias
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = bmm_f32(probs.view(b * nh, s, s), v.reshape(b * nh, s, dh))
            ctx = ctx.view(b, nh, s, dh).to(x.dtype)
        ctx = ctx.transpose(1, 2).reshape(b, s, h)
        return self.o(ctx)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.attention(x, mask, mask_bias))
        approx = "tanh" if use_approx_gelu(self.cfg) else "none"
        ffn = torch.nn.functional.gelu(self.fc1(x), approximate=approx)
        return self.ln2(x + self.fc2(ffn))


class ClassifierHead(nn.Module):
    """dense -> tanh -> out over the CLS state (Roberta and BERT heads alike)."""

    def __init__(self, cfg: XLMRConfig, device=None, dtype=None):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, device, dtype)
        self.out = Dense(cfg.hidden_size, cfg.num_labels, device, dtype)

    def forward(self, cls: torch.Tensor) -> torch.Tensor:
        return self.out(torch.tanh(self.dense(cls)))


class XLMRModel(nn.Module):
    """Embeddings + encoder layers (+ classifier head when ``num_labels``)."""

    def __init__(self, cfg: XLMRConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg

        def table(n):
            return nn.Parameter(torch.empty(n, h, device=device, dtype=dtype), requires_grad=False)

        self.word = table(cfg.vocab_size)
        self.position = table(cfg.max_position)
        self.token_type = table(cfg.type_vocab_size)
        self.ln = LayerNorm32(h, cfg.layer_norm_eps, device)
        self.layers = nn.ModuleList(XLMRLayer(cfg, device, dtype) for _ in range(cfg.num_layers))
        self.classifier = ClassifierHead(cfg, device, dtype) if cfg.num_labels else None

    @property
    def dtype(self) -> torch.dtype:
        return self.word.dtype

    @property
    def device(self) -> torch.device:
        return self.word.device

    @classmethod
    def random_init(
        cls, cfg: XLMRConfig, device, dtype=torch.bfloat16, seed: int = 0
    ) -> "XLMRModel":
        """Random weights at the configured width: N(0, 0.02) tables and dense
        weights, zero biases, unit LayerNorms, drawn on ``device`` from a
        seeded ``torch.Generator``."""
        model = cls(cfg, device=device, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        for name, p in model.named_parameters():
            if name.endswith(".weight") and ".ln" not in f".{name}":
                p.normal_(0.0, 0.02, generator=gen)
            elif name in ("word", "position", "token_type"):
                p.normal_(0.0, 0.02, generator=gen)
        return model

    @classmethod
    def from_state_dict(
        cls, cfg: XLMRConfig, state_dict: dict, device, dtype=torch.bfloat16
    ) -> "XLMRModel":
        model = cls(cfg, device=device, dtype=dtype)
        model.load_state_dict(state_dict, strict=True)
        return model

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    def replicate(self, device) -> "XLMRModel":
        """A copy of this model's parameters on ``device``, each in its own
        dtype (the data-parallel forwards hold one per distinct device)."""
        replica = type(self)(self.cfg, device="meta", dtype=self.dtype)
        replica.load_state_dict({k: v.to(device) for k, v in self.state_dict().items()}, assign=True)
        return replica


def encoder_forward(
    model: XLMRModel,
    ids: torch.Tensor,
    mask: torch.Tensor,
    type_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, S) int ids + mask -> (B, S, H) last hidden states."""
    cfg = model.cfg
    if cfg.position_style == "bert":
        pos_ids = torch.arange(ids.shape[1], device=ids.device).expand_as(ids)
    else:
        pos_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
    if type_ids is None:
        type_ids = torch.zeros_like(ids)
    # Out-of-range ids clamp to the last row, as the reference's XLA gather
    # does (e.g. a fallback tokenizer hashing into a larger vocabulary).
    ids = ids.long().clamp(max=cfg.vocab_size - 1)
    x = model.word[ids] + model.position[pos_ids.long()] + model.token_type[type_ids.long()]
    x = model.ln(x)
    mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.float32)
    for layer in model.layers:
        x = layer(x, mask, mask_bias)
    return x


def cls_embed(model: XLMRModel, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Dense sentence embedding, f32 (B, H), L2-normalised; CLS or masked-mean
    pooling per ``cfg.pooling``."""
    hidden = encoder_forward(model, ids, mask)
    if model.cfg.pooling == "mean":
        m = mask.float()[:, :, None]
        pooled = (hidden.float() * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
    else:
        pooled = hidden[:, 0, :].float()
    return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-12)


def rerank_logits(
    model: XLMRModel,
    ids: torch.Tensor,
    mask: torch.Tensor,
    type_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Cross-encoder relevance logit per (query, doc) pair: f32 (B,). Callers
    apply sigmoid."""
    hidden = encoder_forward(model, ids, mask, type_ids=type_ids)
    return model.classifier(hidden[:, 0, :]).float()[:, 0]


def cast_params(model: XLMRModel, dtype: torch.dtype) -> XLMRModel:
    """Cast float params to ``dtype`` in place, keeping LayerNorms in f32."""
    for name, p in model.named_parameters():
        if ".ln" in f".{name}" or not p.is_floating_point():
            continue
        p.data = p.data.to(dtype)
    return model


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


_LAYER_DENSE = ("q", "k", "v", "o", "fc1", "fc2")


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """The reference's parameter pytree (numpy leaves; stacked (L, in, out)
    layer weights, ``init_params`` / ``convert_state_dict`` layout) -> a
    state dict for :class:`XLMRModel`."""
    emb = np_params["embeddings"]
    sd = {
        "word": _to_torch(emb["word"]),
        "position": _to_torch(emb["position"]),
        "token_type": _to_torch(emb["token_type"]),
        "ln.weight": _to_torch(emb["ln_scale"]),
        "ln.bias": _to_torch(emb["ln_bias"]),
    }
    layers = np_params["layers"]
    n_layers = np.asarray(layers["q_w"]).shape[0]
    for i in range(n_layers):
        for name in _LAYER_DENSE:
            sd[f"layers.{i}.{name}.weight"] = _to_torch(np.asarray(layers[f"{name}_w"])[i].T)
            sd[f"layers.{i}.{name}.bias"] = _to_torch(np.asarray(layers[f"{name}_b"])[i])
        for ln in ("ln1", "ln2"):
            sd[f"layers.{i}.{ln}.weight"] = _to_torch(np.asarray(layers[f"{ln}_scale"])[i])
            sd[f"layers.{i}.{ln}.bias"] = _to_torch(np.asarray(layers[f"{ln}_bias"])[i])
    if "classifier" in np_params:
        head = np_params["classifier"]
        for name in ("dense", "out"):
            sd[f"classifier.{name}.weight"] = _to_torch(np.asarray(head[f"{name}_w"]).T)
            sd[f"classifier.{name}.bias"] = _to_torch(np.asarray(head[f"{name}_b"]))
    return sd
