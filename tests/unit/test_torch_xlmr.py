"""Parity of the port's XLM-R encoder (tensortruth_tpu_torch/models/xlmr.py)
with the reference's (tensortruth_tpu/models/xlmr.py) on tiny configs.

The reference's parameters (``init_params``, numpy leaves) go into the port
through ``params_from_jax``. Float32: hidden states within 2e-5 absolute (the
same f32 math summed in other orders, through a few layers). bf16: compared
by ranking and a stated loose tolerance, since bf16 rounds at different
places in the two frameworks.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensortruth_tpu.models import xlmr as ref
from tensortruth_tpu_torch.models import xlmr as port

torch.set_num_threads(1)

ATOL = 2e-5
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position=130)


def _cfgs(**kw):
    return ref.XLMRConfig(**TINY, **kw), port.XLMRConfig(**TINY, **kw)


def _params(cfg, seed=0, dtype=jnp.float32):
    return ref.init_params(cfg, jax.random.PRNGKey(seed), dtype=dtype)


def _model(tcfg, params, dtype=torch.float32):
    """The port's model holding the reference's ``params`` (numpy leaves)."""
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return port.XLMRModel.from_state_dict(tcfg, port.params_from_jax(np_params), device="cpu", dtype=dtype)


def _batch(rng, bsz=4, seq=19, pad_id=1):
    ids = rng.integers(5, TINY["vocab_size"], size=(bsz, seq)).astype(np.int32)
    mask = np.ones((bsz, seq), np.int32)
    mask[1:2, 11:] = 0  # ragged rows (when the batch has them)
    mask[2:3, 4:] = 0
    ids[mask == 0] = pad_id
    return ids, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (position_style, pooling, approx_gelu, type_vocab_size)
VARIANTS = [
    ("xlmr", "cls", None, 1),
    ("xlmr", "mean", None, 1),
    ("bert", "cls", None, 2),
    ("bert", "mean", False, 2),
    ("xlmr", "cls", True, 1),
]


@pytest.mark.parametrize("position_style,pooling,approx_gelu,type_vocab", VARIANTS)
def test_encoder_and_cls_embed_match_reference(position_style, pooling, approx_gelu, type_vocab):
    rcfg, tcfg = _cfgs(position_style=position_style, pooling=pooling, approx_gelu=approx_gelu,
                       type_vocab_size=type_vocab)
    params = _params(rcfg, seed=3)
    model = _model(tcfg, params)
    ids, mask = _batch(np.random.default_rng(0))
    type_ids = (np.arange(ids.shape[1])[None, :] > 6).astype(np.int32) * (type_vocab - 1) * mask
    want_h = np.asarray(ref.encoder_forward(params, *(jnp.asarray(a) for a in (ids, mask)), rcfg,
                                            type_ids=jnp.asarray(type_ids)))
    want_e = np.asarray(ref.cls_embed(params, jnp.asarray(ids), jnp.asarray(mask), rcfg))
    with torch.inference_mode():
        got_h = port.encoder_forward(model, *_t(ids, mask), type_ids=torch.from_numpy(type_ids)).numpy()
        got_e = port.cls_embed(model, *_t(ids, mask)).numpy()
    valid = mask.astype(bool)  # padded positions are unused by every head
    np.testing.assert_allclose(got_h[valid], want_h[valid], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_e, want_e, atol=ATOL, rtol=0)


@pytest.mark.parametrize("position_style,approx_gelu", [("xlmr", None), ("bert", None), ("xlmr", True)])
def test_rerank_logits_match_reference(position_style, approx_gelu):
    type_vocab = 2 if position_style == "bert" else 1
    rcfg, tcfg = _cfgs(num_labels=1, position_style=position_style, approx_gelu=approx_gelu,
                       type_vocab_size=type_vocab)
    params = _params(rcfg, seed=4)
    ids, mask = _batch(np.random.default_rng(1), bsz=6)
    type_ids = ((np.arange(ids.shape[1])[None, :] > 5) & (mask > 0)).astype(np.int32) * (type_vocab - 1)
    want = np.asarray(ref.rerank_logits(params, jnp.asarray(ids), jnp.asarray(mask), rcfg,
                                        type_ids=jnp.asarray(type_ids)))
    with torch.inference_mode():
        got = port.rerank_logits(_model(tcfg, params), *_t(ids, mask), torch.from_numpy(type_ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_gelu_flavors_differ_and_are_honoured():
    rcfg, tcfg = _cfgs(num_labels=1, approx_gelu=True)
    params = _params(rcfg, seed=5)
    ids, mask = _batch(np.random.default_rng(2))
    with torch.inference_mode():
        approx = port.rerank_logits(_model(tcfg, params), *_t(ids, mask)).numpy()
        exact = port.rerank_logits(_model(replace(tcfg, approx_gelu=False), params), *_t(ids, mask)).numpy()
    assert not np.array_equal(approx, exact)
    np.testing.assert_allclose(approx, exact, atol=5e-3)
    assert port.use_approx_gelu(tcfg) and not port.use_approx_gelu(replace(tcfg, approx_gelu=None))


def test_flash_path_matches_naive_path():
    """cfg.flash_attention routes S=256 through blocked_attention (its plain
    version on the CPU); the result equals the inline attention's."""
    rcfg, tcfg = (replace(c, max_position=300) for c in _cfgs())
    model = _model(tcfg, _params(rcfg, seed=6))
    ids, mask = _batch(np.random.default_rng(3), seq=256)
    with torch.inference_mode():
        naive = port.cls_embed(model, *_t(ids, mask))
        model.cfg = replace(tcfg, flash_attention=True)
        for layer in model.layers:
            layer.cfg = model.cfg
        flash = port.cls_embed(model, *_t(ids, mask))
    torch.testing.assert_close(flash, naive, atol=1e-5, rtol=0)


def test_bf16_matches_reference_by_ranking():
    """bf16 weights on both sides: embeddings within a loose 2e-2 and the
    similarity ranking of docs against a query identical; rerank logits
    (spread out by scaling the output layer) in the same order."""
    rcfg, tcfg = _cfgs(num_labels=1)
    p32 = ref.init_params(rcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    p32["classifier"]["out_w"] = p32["classifier"]["out_w"] * 200.0
    p16 = ref.cast_params(p32, jnp.bfloat16)
    model = _model(tcfg, p16, dtype=torch.bfloat16)
    assert model.ln.weight.dtype == torch.float32 and model.word.dtype == torch.bfloat16
    ids, mask = _batch(np.random.default_rng(4), bsz=8)
    ecfg = replace(rcfg, num_labels=0)
    want_e = np.asarray(ref.cls_embed(p16, jnp.asarray(ids), jnp.asarray(mask), ecfg))
    want_l = np.asarray(ref.rerank_logits(p16, jnp.asarray(ids), jnp.asarray(mask), rcfg))
    with torch.inference_mode():
        got_e = port.cls_embed(model, *_t(ids, mask)).numpy()
        got_l = port.rerank_logits(model, *_t(ids, mask)).numpy()
    np.testing.assert_allclose(got_e, want_e, atol=2e-2)
    sims_want, sims_got = want_e[1:] @ want_e[0], got_e[1:] @ got_e[0]
    np.testing.assert_array_equal(np.argsort(-sims_got), np.argsort(-sims_want))
    np.testing.assert_array_equal(np.argsort(-got_l), np.argsort(-want_l))


def test_cast_params_keeps_layernorm_f32():
    _, tcfg = _cfgs(num_labels=1)
    model = port.cast_params(port.XLMRModel.random_init(tcfg, "cpu", dtype=torch.float32), torch.bfloat16)
    for name, p in model.named_parameters():
        want = torch.float32 if ".ln" in f".{name}" else torch.bfloat16
        assert p.dtype == want, name


def test_random_init_is_seeded_and_on_device():
    _, tcfg = _cfgs(num_labels=1)
    a = port.XLMRModel.random_init(tcfg, "cpu", seed=1)
    b = port.XLMRModel.random_init(tcfg, "cpu", seed=1)
    c = port.XLMRModel.random_init(tcfg, "cpu", seed=2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.q.weight"], sc["layers.0.q.weight"])
    assert a.device.type == "cpu" and a.dtype == torch.bfloat16
    assert abs(sa["word"].float().std().item() - 0.02) < 2e-3
    assert torch.equal(sa["layers.1.ln2.weight"], torch.ones(64))


def test_position_ids_respect_padding():
    """Same content with and without trailing padding gives the same CLS."""
    rcfg, tcfg = _cfgs()
    model = _model(tcfg, _params(rcfg, seed=8))
    ids, _ = _batch(np.random.default_rng(5), bsz=1, seq=10)
    ids_pad = np.full((1, 16), 1, np.int32)
    ids_pad[:, :10] = ids
    mask_pad = np.zeros((1, 16), np.int32)
    mask_pad[:, :10] = 1
    with torch.inference_mode():
        e1 = port.cls_embed(model, *_t(ids, np.ones((1, 10), np.int32)))
        e2 = port.cls_embed(model, *_t(ids_pad, mask_pad))
    torch.testing.assert_close(e1, e2, atol=1e-6, rtol=0)


def test_out_of_vocab_ids_clamp_like_the_reference():
    rcfg, tcfg = _cfgs()
    params = _params(rcfg, seed=9)
    ids = np.array([[0, 5, 511, 600, 250000]], np.int32)
    mask = np.ones_like(ids)
    want = np.asarray(ref.cls_embed(params, jnp.asarray(ids), jnp.asarray(mask), rcfg))
    with torch.inference_mode():
        got = port.cls_embed(_model(tcfg, params), *_t(ids, mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
