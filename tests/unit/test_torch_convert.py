"""The port's checkpoint loader (tensortruth_tpu_torch/models/convert.py)
against HF ``transformers`` and the reference's ``convert_state_dict`` path.

Tiny models are built locally by ``transformers`` (no download). Float32
throughout; tolerance 2e-4 against HF (other kernels and summation orders,
as the reference's own HF parity tests use) and 2e-5 against the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from tensortruth_tpu.models.convert import convert_state_dict
from tensortruth_tpu.models import xlmr as ref
from tensortruth_tpu_torch.models import convert
from tensortruth_tpu_torch.models import xlmr as port

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=130, layer_norm_eps=1e-5)
HF_ATOL = 2e-4
REF_ATOL = 2e-5


def _batch(seed=0, bsz=3, seq=17, pad_id=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, TINY["vocab_size"], size=(bsz, seq)).astype(np.int32)
    mask = np.ones((bsz, seq), np.int32)
    mask[1, 10:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = pad_id
    return ids, mask


def _port_cfg(hf_cfg, num_labels=0, position_style="xlmr"):
    return port.XLMRConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size, num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads, intermediate_size=hf_cfg.intermediate_size,
        max_position=hf_cfg.max_position_embeddings, type_vocab_size=hf_cfg.type_vocab_size,
        pad_token_id=hf_cfg.pad_token_id, num_labels=num_labels, position_style=position_style,
    )


def _ref_cfg(pcfg):
    return ref.XLMRConfig(**{f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__})


def test_xlmr_encoder_matches_hf_and_reference():
    torch.manual_seed(0)
    hf_cfg = transformers.XLMRobertaConfig(**TINY, type_vocab_size=1, pad_token_id=1)
    hf = transformers.XLMRobertaModel(hf_cfg, add_pooling_layer=False).eval()
    ids, mask = _batch()
    cfg = _port_cfg(hf_cfg)
    model = port.XLMRModel.from_state_dict(
        cfg, convert.state_dict_from_hf(hf.state_dict(), cfg.num_layers), device="cpu", dtype=torch.float32
    )
    with torch.inference_mode():
        want = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long()).last_hidden_state
        got = port.encoder_forward(model, torch.from_numpy(ids), torch.from_numpy(mask))
    valid = torch.from_numpy(mask).bool()
    torch.testing.assert_close(got[valid], want[valid], atol=HF_ATOL, rtol=0)

    params = convert_state_dict(hf.state_dict(), num_layers=cfg.num_layers, dtype=jnp.float32)
    ref_h = np.asarray(ref.encoder_forward(params, jnp.asarray(ids), jnp.asarray(mask), _ref_cfg(cfg)))
    np.testing.assert_allclose(got.numpy()[mask > 0], ref_h[mask > 0], atol=REF_ATOL, rtol=0)


def test_xlmr_classifier_matches_hf_and_reference():
    torch.manual_seed(1)
    hf_cfg = transformers.XLMRobertaConfig(**TINY, type_vocab_size=1, pad_token_id=1, num_labels=1)
    hf = transformers.XLMRobertaForSequenceClassification(hf_cfg).eval()
    ids, mask = _batch(seed=1)
    cfg = _port_cfg(hf_cfg, num_labels=1)
    model = port.XLMRModel.from_state_dict(
        cfg, convert.state_dict_from_hf(hf.state_dict(), cfg.num_layers, num_labels=1), "cpu", torch.float32
    )
    with torch.inference_mode():
        want = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long()).logits[:, 0]
        got = port.rerank_logits(model, torch.from_numpy(ids), torch.from_numpy(mask))
    torch.testing.assert_close(got, want, atol=HF_ATOL, rtol=0)
    params = convert_state_dict(hf.state_dict(), num_layers=cfg.num_layers, num_labels=1, dtype=jnp.float32)
    ref_l = np.asarray(ref.rerank_logits(params, jnp.asarray(ids), jnp.asarray(mask), _ref_cfg(cfg)))
    np.testing.assert_allclose(got.numpy(), ref_l, atol=REF_ATOL, rtol=0)


def test_bert_classifier_with_segment_ids_matches_hf():
    torch.manual_seed(2)
    hf_cfg = transformers.BertConfig(**TINY, type_vocab_size=2, pad_token_id=0, num_labels=1)
    hf = transformers.BertForSequenceClassification(hf_cfg).eval()
    ids, mask = _batch(seed=2, pad_id=0)
    type_ids = ((np.arange(ids.shape[1])[None, :] > 6) & (mask > 0)).astype(np.int32)
    cfg = _port_cfg(hf_cfg, num_labels=1, position_style="bert")
    model = port.XLMRModel.from_state_dict(
        cfg, convert.state_dict_from_hf(hf.state_dict(), cfg.num_layers, num_labels=1), "cpu", torch.float32
    )
    with torch.inference_mode():
        want = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(),
                  token_type_ids=torch.from_numpy(type_ids).long()).logits[:, 0]
        got = port.rerank_logits(model, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(type_ids))
    torch.testing.assert_close(got, want, atol=HF_ATOL, rtol=0)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_local_checkpoint_dir(tmp_path, fmt):
    """A saved HF directory: config.json -> XLMRConfig, weights -> model."""
    torch.manual_seed(3)
    hf_cfg = transformers.XLMRobertaConfig(**TINY, type_vocab_size=1, pad_token_id=1, num_labels=1)
    hf = transformers.XLMRobertaForSequenceClassification(hf_cfg).eval()
    hf.config.save_pretrained(tmp_path)
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in hf.state_dict().items()}, str(tmp_path / "model.safetensors"))
    else:
        torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
    cfg = convert.config_from_hf(str(tmp_path), num_labels=1)
    assert (cfg.num_layers, cfg.hidden_size, cfg.position_style) == (3, 64, "xlmr")
    model = convert.load_local_checkpoint(str(tmp_path), cfg, device="cpu", dtype=torch.float32)
    ids, mask = _batch(seed=3)
    with torch.inference_mode():
        want = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long()).logits[:, 0]
        got = port.rerank_logits(model, torch.from_numpy(ids), torch.from_numpy(mask))
    torch.testing.assert_close(got, want, atol=HF_ATOL, rtol=0)


def test_config_from_hf_pooling_and_unsupported(tmp_path):
    transformers.BertConfig(**TINY).save_pretrained(tmp_path)
    (tmp_path / "1_Pooling").mkdir()
    (tmp_path / "1_Pooling" / "config.json").write_text('{"pooling_mode_mean_tokens": true}')
    cfg = convert.config_from_hf(str(tmp_path))
    assert (cfg.position_style, cfg.pooling, cfg.pad_token_id) == ("bert", "mean", 0)
    assert convert.config_from_hf(str(tmp_path / "missing")) is None
    (tmp_path / "config.json").write_text('{"model_type": "gpt2"}')
    assert convert.config_from_hf(str(tmp_path)) is None


def test_manager_loads_local_checkpoint_and_caches_by_key(tmp_path, monkeypatch):
    """ModelManager: discover_checkpoint's order finds a saved HF directory,
    the architecture comes from its config.json, the resident model is
    reused for the same spec and device and swapped for another dtype."""
    from tensortruth_tpu_torch.models import manager as mm

    torch.manual_seed(4)
    hf_cfg = transformers.XLMRobertaConfig(**TINY, type_vocab_size=1, pad_token_id=1)
    hf = transformers.XLMRobertaModel(hf_cfg, add_pooling_layer=False).eval()
    hf.save_pretrained(tmp_path / "org--local-xlmr" / "local-xlmr")
    monkeypatch.setenv("TENSOR_TRUTH_TPU_MODELS_DIR", str(tmp_path / "org--local-xlmr"))
    mm.ModelManager.reset_instance()
    monkeypatch.setattr(mm.ModelManager, "_discovery_cache", {})
    mgr = mm.ModelManager.get_instance()

    emb = mgr.get_embedder(mm.ModelSpec("org/local-xlmr", dtype="float32"), device="cpu")
    assert (emb.cfg.num_layers, emb.cfg.hidden_size, emb.device.type) == (3, 64, "cpu")
    assert emb.max_length == 128  # clamped to the position table
    assert mgr.get_embedder(mm.ModelSpec("org/local-xlmr", dtype="float32"), device="cpu") is emb
    ids, mask = _batch(seed=4)
    with torch.inference_mode():
        want = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long()).last_hidden_state
        got = port.encoder_forward(emb.model, torch.from_numpy(ids), torch.from_numpy(mask))
    valid = torch.from_numpy(mask).bool()
    torch.testing.assert_close(got[valid], want[valid], atol=HF_ATOL, rtol=0)

    swapped = mgr.get_embedder(mm.ModelSpec("org/local-xlmr", dtype="bfloat16"), device="cpu")
    assert swapped is not emb and swapped.model.dtype == torch.bfloat16
    rr = mgr.get_reranker(mm.ModelSpec("tiny-reranker"), device="cpu")
    assert rr.cfg.num_labels == 1 and rr.model.word.dtype == torch.bfloat16
    status = mgr.status()
    assert status["embedder"]["param_bytes"] == swapped.param_bytes() and status["reranker"]["key"][0] == "tiny-reranker"
    mm.ModelManager.reset_instance()
