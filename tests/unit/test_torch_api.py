"""Reference APIs of the service, engine, embedder and model manager in the
port, against the reference's on the same inputs, on the CPU.

* ``RAGService.needs_reload`` over the cases ``test_rag_service.py`` pins for
  the reference (same modules and params, other params, other modules), and
  ``RAGEngine.similarity_top_k``, with each package's service loaded over
  one index dir (``test_torch_e2e.py``'s fixtures).
* ``Embedder.encode_one`` is ``encode([text])[0]``, and within 1e-5 of the
  reference's (float32 math in other orders through two encoder layers).
* ``register_embedder_arch`` / ``register_reranker_arch`` make an id known to
  the manager, as in the reference.
* The managers' reuse rule: a caller that names no device reuses the
  resident model wherever it is (the reference's ``mesh=None``), with no
  reload; a named device must match, ``cuda`` meaning the current card.
"""

import logging

import numpy as np
import pytest
import torch
from test_torch_e2e import QUERIES, TINY, _services, env, runtimes  # noqa: F401 (fixtures)

from tensortruth_tpu.models import manager as ref_manager
from tensortruth_tpu.models.xlmr import XLMRConfig as RefXLMRConfig
from tensortruth_tpu_torch.models import manager as port_manager
from tensortruth_tpu_torch.models.xlmr import XLMRConfig

torch.set_num_threads(1)


def test_needs_reload_matches_reference(env):
    ref, port, _ = _services(env, {"reranker_top_n": 3})
    cases = [
        (["alpha", "beta"], {"reranker_top_n": 3}),  # the engine loaded
        (["beta", "alpha"], {"reranker_top_n": 3}),  # module order does not matter
        (["alpha", "beta"], {"reranker_top_n": 5}),
        (["alpha"], {"reranker_top_n": 3}),
        (["alpha", "beta", "gamma"], {"reranker_top_n": 3}),
    ]
    got = [port.needs_reload(m, p) for m, p in cases]
    assert got == [ref.needs_reload(m, p) for m, p in cases] == [False, False, True, True, True]
    port.unload()
    ref.unload()
    assert port.needs_reload(*cases[0]) and ref.needs_reload(*cases[0])


@pytest.mark.parametrize("top_n", [1, 3, 7])
def test_similarity_top_k_matches_reference(env, top_n):
    ref, port, _ = _services(env, {"reranker_top_n": top_n})
    assert port.engine.similarity_top_k == ref.engine.similarity_top_k == max(5, 2 * top_n)


@pytest.mark.parametrize("is_query", [True, False])
def test_encode_one_matches_reference(runtimes, is_query):
    ref_emb, port_emb = runtimes["ref"][0], runtimes["port"][0]
    for text in QUERIES:
        one = port_emb.encode_one(text, is_query=is_query)
        assert one.shape == (TINY["hidden_size"],) and one.dtype == np.float32
        np.testing.assert_array_equal(one, port_emb.encode([text], is_query=is_query)[0])
        np.testing.assert_allclose(one, ref_emb.encode_one(text, is_query=is_query), atol=1e-5)


@pytest.mark.parametrize("role", ["embedder", "reranker"])
def test_register_arch_matches_reference(monkeypatch, role):
    registry = f"_{role.upper()}_ARCHS"
    for mod in (ref_manager, port_manager):  # registrations end with the test
        monkeypatch.setattr(mod, registry, dict(getattr(mod, registry)))
    fields = dict(TINY, num_layers=1, num_labels=1 if role == "reranker" else 0)
    getattr(ref_manager, f"register_{role}_arch")("org/small", RefXLMRConfig(**fields))
    getattr(port_manager, f"register_{role}_arch")("org/small", XLMRConfig(**fields))
    ref_cfg, cfg = getattr(ref_manager, registry)["org/small"], getattr(port_manager, registry)["org/small"]
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == {
        f: getattr(ref_cfg, f) for f in ref_cfg.__dataclass_fields__
    }
    port_manager.ModelManager.reset_instance()
    try:
        mgr = port_manager.ModelManager.get_instance()
        model = getattr(mgr, f"get_{role}")(port_manager.ModelSpec("org/small", dtype="float32"), device="cpu")
        assert model.cfg.num_layers == 1 and model.model_id == "org/small"
    finally:
        port_manager.ModelManager.reset_instance()


@pytest.mark.parametrize("role,model_id", [("embedder", "tiny-embedder"), ("reranker", "tiny-reranker")])
def test_unnamed_device_reuses_the_resident_model(caplog, role, model_id):
    port_manager.ModelManager.reset_instance()
    try:
        mgr = port_manager.ModelManager.get_instance()
        get = getattr(mgr, f"get_{role}")
        spec = port_manager.ModelSpec(model_id, dtype="float32")
        model = get(spec, device="cpu")
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=port_manager.__name__):
            assert get(spec) is model
            assert get(spec, device="cpu") is model
        assert not caplog.records  # no swap, no load
        assert getattr(mgr, f"_{role}_key")[-1] == "cpu"
    finally:
        port_manager.ModelManager.reset_instance()


def test_named_device_is_matched_with_its_index(monkeypatch):
    """``cuda`` names the current card: ``cuda`` and ``cuda:0`` are one key
    when card 0 is current, and another card's key differs."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    spec = port_manager.ModelSpec("tiny-embedder")
    resident = (*spec.key(), "cuda:0")
    match = port_manager.ModelManager._key_matches
    assert port_manager._device_of("cuda") == torch.device("cuda", 0)
    assert port_manager._device_of(None) == torch.device("cuda", 0)
    assert port_manager._device_of("cpu") == torch.device("cpu")
    assert match(resident, spec, "cuda") and match(resident, spec, "cuda:0") and match(resident, spec, None)
    assert not match(resident, spec, "cuda:1") and not match(resident, spec, "cpu")
    assert not match(resident, port_manager.ModelSpec("tiny-embedder", dtype="float32"), None)
