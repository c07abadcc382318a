#!/usr/bin/env python3
"""The values that hold each model family to what the harness read before
the families were split out, on the CPU in a few seconds:

    python3 benchmark_torch/tools/family_golden.py --harness <checkout> [--out FILE]

``--harness`` is the root of a checkout whose ``benchmark_torch/`` is read
(default: this one); ``--out`` the JSON file written (default
``benchmark_torch/tests/family_golden.json``, which
``tests/test_families.py`` compares with). For every role of every
configuration in ``BENCHMARK.json``: the weights' names and shapes at
published widths, the weights drawn at the tiny sizes (seed 31, float32
and bf16) as SHA-256 digests, the operation count over ``LENS`` and the
token counts of ``SEQ`` under each of ``MAX_LENGTHS``; and the tiny
reference's embeddings of ``TEXTS`` and scores of ``PAIRS`` on one thread,
as numbers, with the torch version and CPU they were read on. A checkout
from before the families reads ``weights.shapes``, ``arith.encoder_flops``
and ``readers.seq_len``; a later one each role's family.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import platform
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "benchmark_torch" / "tests" / "family_golden.json"
ROLES = ("embedder", "reranker")
SEED = 31
LENS = [1, 2, 3, 7, 9, 16, 64, 130, 255, 511, 512, 1023, 2047, 2048]
SEQ = [(0, None), (1, None), (9, None), (127, None), (2046, None), (5000, None),
       (1, 1), (9, 118), (9, 242), (30, 215), (600, 900), (1022, 1500), (1023, 1023), (3000, 5000),
       (100, 5), (3000, 1)]
MAX_LENGTHS = [5, 7, 16, 128, 129, 512, 2048]
TEXTS = ["what is the boiling point of water at sea level",
         "who wrote the declaration of independence",
         "a", "how many moons does jupiter have and which is the largest one of them all",
         " ".join(f"word{i % 37}" for i in range(200)), "Paris, France: the capital?",
         "transformers use attention over tokens", "the quick brown fox jumps over the lazy dog"]
PAIRS = [(TEXTS[i], TEXTS[(i + 3) % 8] + " " + TEXTS[(i + 5) % 8]) for i in range(8)]


def environment() -> dict:
    import torch

    return {"torch": torch.__version__, "machine": platform.machine(),
            "cpu_capability": torch.backends.cpu.get_cpu_capability()}


def sha_weights(w: dict) -> str:
    import torch

    d = hashlib.sha256()
    for k, v in w.items():
        d.update(f"{k}|{v.dtype}|{tuple(v.shape)}|".encode())
        d.update(v.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return d.hexdigest()


def role_values(m: dict, tiny: dict, role: str) -> dict:
    """A role's names and shapes, weights, operation and token counts, by
    its family where the harness has families."""
    import torch

    from benchmark_torch.harness import weights

    try:
        from benchmark_torch.harness.families import family
    except ImportError:
        from benchmark_torch.harness import arith, readers

        shapes, flops, seq_len = weights.shapes, arith.encoder_flops, readers.seq_len
    else:
        shapes, flops, seq_len = family(m).shapes, family(m).flops, family(m).seq_len
    dense, norms = shapes(m)
    listed = [[n, list(s)] for n, s in dense + norms]
    seed = weights.role_seed(SEED, role)
    return {
        "n_shapes": len(listed),
        "shapes": hashlib.sha256(json.dumps(listed).encode()).hexdigest(),
        "weights_f32": sha_weights(weights.make_weights(tiny, seed, "cpu", torch.float32)),
        "weights_bf16": sha_weights(weights.make_weights(tiny, seed, "cpu")),
        "flops": flops(m, LENS),
        "seq_lens": [seq_len(a, b, n) for n in MAX_LENGTHS for a, b in SEQ],
        "model_id": tiny["model_id"],
        "hidden_size": tiny["hidden_size"],
    }


def reference_values(tiny_config: dict) -> dict:
    """The tiny reference's embeddings and scores, read on one thread."""
    import torch

    from benchmark_torch.harness import check

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = check.Reference(tiny_config, SEED, torch.device("cpu"))
        return {"embed": ref.embed(TEXTS).tolist(), "scores": ref.scores(PAIRS).tolist()}
    finally:
        torch.set_num_threads(threads)


def capture(root: Path = ROOT) -> dict:
    """Every value above, read from the harness of the checkout at ``root``
    (which has to be the first ``benchmark_torch`` on the path)."""
    from benchmark_torch.harness import chat
    from benchmark_torch.harness.common import load_json

    bench = json.loads((root / "BENCHMARK.json").read_text())
    out = {"environment": environment(), "configs": {}}
    for c in bench["configs"]:
        config = load_json(root / c["file"])
        tiny = chat.tiny_config(config)
        out["configs"][c["name"]] = {
            "roles": {role: role_values(config[role], tiny[role], role) for role in ROLES},
            "corpus_dim": tiny["corpus"]["dim"],
            "reference": reference_values(tiny),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--harness", type=Path, default=ROOT, help="root of the checkout whose harness is read")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    root = args.harness.resolve()
    sys.path.insert(0, str(root))
    for name in [n for n in sys.modules if n.split(".")[0] == "benchmark_torch"]:
        del sys.modules[name]
    values = capture(root)
    args.out.write_text(json.dumps(values, indent=1) + "\n")
    print(f"wrote {args.out} from {root} ({values['environment']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
