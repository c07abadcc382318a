"""The model families (``harness/families.py``, ``families/<name>.py``), on
the CPU in this process, in a few seconds:

    python -m pytest benchmark_torch/tests/test_families.py -q

* golden values: for every role of both XLM-R configurations, the weights'
  names and shapes at published widths, the weights drawn at the tiny sizes
  (seed 31, float32 and bf16), the operation and token counts at published
  widths, and the tiny reference's embeddings and scores on fixed texts are
  those of the harness before the families were split out
  (``family_golden.json``, read by ``tools/family_golden.py``), bit for bit
  on the torch version and CPU they were read on, within 1e-6 elsewhere;
* an architecture no family serves raises, naming the known families;
* a second family and a reference file holding only its class, written as
  new files beside a copy of the existing ones, are taken by the weights,
  the seating, the tiny sizes, the reference and the operation count, also
  with the two roles of one configuration in different families.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark_torch"
sys.path.insert(0, str(ROOT))

from benchmark_torch.harness import chat, check, families, readers  # noqa: E402
from benchmark_torch.harness.common import load_json  # noqa: E402
from benchmark_torch.harness.weights import make_weights, role_seed  # noqa: E402
from benchmark_torch.tools import family_golden as fg  # noqa: E402

ROLES = fg.ROLES
CONFIGS = ("bge-m3.flat-1m", "bge-m3.ivf-2m")
TEXTS, PAIRS = fg.TEXTS, fg.PAIRS
# Read from the harness before the families were split out by
# ``tools/family_golden.py --harness <that checkout>``.
GOLDEN = json.loads(fg.OUT.read_text())


def config_of(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("role", ROLES)
def test_golden_shapes_weights_and_counts(name, role):
    config = config_of(name)
    m, tiny = config[role], chat.tiny_config(config)[role]
    assert families.family(m) is families.load_all(families.DIR)["xlmr"]
    assert fg.role_values(m, tiny, role) == GOLDEN["configs"][name]["roles"][role]


@pytest.mark.parametrize("name", CONFIGS)
def test_golden_tiny_reference(name):
    """Bit for bit on the torch version and CPU the values were read on;
    elsewhere a float32 forward may round differently, within 1e-6."""
    tiny = chat.tiny_config(config_of(name))
    want = GOLDEN["configs"][name]
    assert tiny["corpus"]["dim"] == want["corpus_dim"]
    got = fg.reference_values(tiny)
    for key in ("embed", "scores"):
        a, b = torch.tensor(got[key]), torch.tensor(want["reference"][key])
        if fg.environment() == GOLDEN["environment"]:
            assert torch.equal(a, b), key
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_unknown_architecture_raises():
    with pytest.raises(ValueError, match="known families: xlmr: XLMRobertaModel"):
        families.family({"architectures": "NoSuchModelForCausalLM"})


def test_every_role_has_its_family_and_reference_class():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        config = load_json(ROOT / c["file"])
        ref = check.load_reference(config)
        assert all(hasattr(ref, f) for f in ("n_tokens", "fp32_mode", "search_dots")), c["name"]
        for role in ROLES:
            file, name = families.family(config[role]).REFERENCE
            assert hasattr(check.load_module(file), name), (c["name"], role)


# A second family for the test: the XLM-R encoder under other weight names,
# at other tiny sizes, with an operation count and a token template of its
# own. It seats the program's only model by renaming back.
STUB_FAMILY = '''
from pathlib import Path

from benchmark_torch.harness.families import load_all

ARCHITECTURES = ("StubEncoder", "StubForSequenceClassification")
REFERENCE = ("stub_reference", "Stub")
NORM_PARAMS = ("weight", "bias")
_TINY = {"vocab_size": 300, "hidden_size": 32, "num_hidden_layers": 3, "num_attention_heads": 4,
         "intermediate_size": 48, "max_position_embeddings": 130, "init_std": 0.2}
TINY = {"embedder": dict(_TINY, model_id="tiny-stub-embedder"), "reranker": dict(_TINY, model_id="tiny-stub-reranker")}


def _base():
    return load_all(Path(__file__).parent)["xlmr"]


def to_stub(name):
    return "stub/" + name.replace(".", "/")


def from_stub(name):
    return name[len("stub/"):].replace("/", ".")


def shapes(m):
    dense, norms = _base().shapes(m)
    return [(to_stub(n), s) for n, s in dense], [(to_stub(n), s) for n, s in norms]


def flops(m, seq_lens):
    return 1000.0 * m["hidden_size"] * sum(seq_lens)


def seq_len(n_a, n_b, max_length):
    return min(max_length, n_a + (n_b or 0) + 1)


def check_program(m, role, cfg):
    _base().check_program(m, role, cfg)


def program_state(cfg, weights):
    return _base().program_state(cfg, {from_stub(k): v for k, v in weights.items()})


def program_model(cfg, weights, device, dtype):
    return _base().program_model(cfg, {from_stub(k): v for k, v in weights.items()}, device, dtype)
'''

STUB_REFERENCE = '''import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("stub_base", Path(__file__).with_name("xlmr_rag_reference.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)


class Stub(_base.XLMR):
    """The XLM-R reference over the stub family's weight names."""

    def __init__(self, m, weights, precision="fp32"):
        super().__init__(m, {k[len("stub/"):].replace("/", "."): v for k, v in weights.items()}, precision)
'''


@pytest.fixture
def stub_root(tmp_path, monkeypatch):
    """A copy of the families and configurations with the stub family and a
    reference file holding its class added, and the lookups pointed at it."""
    shutil.copytree(BENCH_DIR / "families", tmp_path / "families", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "families" / "stub.py").write_text(STUB_FAMILY)
    shutil.copytree(BENCH_DIR / "configs", tmp_path / "configs")
    (tmp_path / "configs" / "stub_reference.py").write_text(STUB_REFERENCE)
    monkeypatch.setattr(families, "DIR", tmp_path / "families")
    monkeypatch.setattr(check, "BENCH_DIR", tmp_path)
    return tmp_path


def stub_config(embedder_arch: str, reranker_arch: str) -> dict:
    config = config_of(CONFIGS[0])
    config["embedder"]["architectures"] = embedder_arch
    config["reranker"]["architectures"] = reranker_arch
    return config


def program_cfg(m: dict):
    from tensortruth_tpu_torch.models.xlmr import XLMRConfig

    return XLMRConfig(vocab_size=m["vocab_size"], hidden_size=m["hidden_size"], num_layers=m["num_hidden_layers"],
                      num_heads=m["num_attention_heads"], intermediate_size=m["intermediate_size"],
                      max_position=m["max_position_embeddings"], num_labels=m["num_labels"])


@pytest.mark.parametrize("embedder_arch", ["StubEncoder", "XLMRobertaModel"], ids=["stub", "mixed"])
def test_second_family_from_new_files(stub_root, monkeypatch, embedder_arch):
    from tensortruth_tpu_torch.models.embedder import Embedder
    from tensortruth_tpu_torch.models.reranker import Reranker

    config = stub_config(embedder_arch, "StubForSequenceClassification")
    stub = families.load_all(stub_root / "families")["stub"]
    xlmr = families.load_all(stub_root / "families")["xlmr"]
    want = {"embedder": stub if embedder_arch == "StubEncoder" else xlmr, "reranker": stub}
    for role in ROLES:
        assert families.family(config[role]) is want[role]

    # tiny sizes: each role its family's, the corpus as wide as the embedder
    tiny = chat.tiny_config(config)
    for role in ROLES:
        assert tiny[role]["model_id"] == want[role].TINY[role]["model_id"]
    assert tiny["corpus"]["dim"] == want["embedder"].TINY["embedder"]["hidden_size"]

    # weights: the family's names
    w = {role: make_weights(tiny[role], role_seed(5, role), "cpu", torch.float32) for role in ROLES}
    assert all(k.startswith("stub/") for k in w["reranker"])
    assert any(k.startswith("stub/") for k in w["embedder"]) == (want["embedder"] is stub)

    # seating: the program's model holds the family's weights
    for cls in (Embedder, Reranker):
        monkeypatch.setattr(cls, "random_init", cls.__dict__["random_init"])
    chat.seat_weights(tiny, 5)
    for role, cls in (("embedder", Embedder), ("reranker", Reranker)):
        runtime = cls.random_init(program_cfg(tiny[role]), None, "cpu", dtype=torch.float32)
        word = "stub/embeddings/word_embeddings/weight" if want[role] is stub else "embeddings.word_embeddings.weight"
        assert torch.equal(runtime.model.state_dict()["word"], w[role][word])
    wrong = dict(tiny["reranker"], hidden_size=64)
    with pytest.raises(RuntimeError, match="the program serves reranker"):
        Reranker.random_init(program_cfg(wrong), None, "cpu", dtype=torch.float32)

    # the reference: each role the class its family names
    ref = check.Reference(tiny, 5, torch.device("cpu"))
    assert type(ref.rr).__name__ == "Stub"
    assert type(ref.emb).__name__ == want["embedder"].REFERENCE[1]
    assert ref.embed(TEXTS[:2]).shape == (2, tiny["embedder"]["hidden_size"])
    assert ref.scores(PAIRS[:3]).shape == (3,)

    # the operation count: each role its family's count over its family's template
    n_tokens = check.load_reference(config).n_tokens
    queries, pairs = TEXTS[:3], PAIRS[:4]
    ctx = SimpleNamespace(config=config, trace_t0=0.0, trace_t1=10.0,
                          probe=SimpleNamespace(queries=[(1.0, queries), (11.0, TEXTS)], reranks=[(2.0, pairs)]))
    emb, rr = config["embedder"], config["reranker"]
    q = [want["embedder"].seq_len(n_tokens(t), None, emb["max_length"]) for t in queries]
    p = [stub.seq_len(n_tokens(a), n_tokens(b), rr["max_length"]) for a, b in pairs]
    assert p == [min(rr["max_length"], n_tokens(a) + n_tokens(b) + 1) for a, b in pairs]
    assert readers.serve_flops(ctx) == want["embedder"].flops(emb, q) + 1000.0 * rr["hidden_size"] * sum(p)
