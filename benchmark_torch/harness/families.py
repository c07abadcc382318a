"""The model family of a configuration's role entry.

A family is a module ``benchmark_torch/families/<name>.py`` of plain
functions and constants: everything the harness knows of one architecture.
It is found by the role entry's ``architectures`` string among the
family's ``ARCHITECTURES``, so a new family is a new file and a
configuration may serve different families in its two roles. Each holds:

* ``ARCHITECTURES``: the Hugging Face architecture names it serves;
* ``REFERENCE``: (file, class) of its plain reference: the class in
  ``configs/<file>.py``, built as ``cls(m, weights, precision)`` with
  ``embed(texts, device)`` and ``scores(pairs, device)``; the
  configuration's own reference file keeps the tokenizer, ``search_dots``
  and ``fp32_mode`` (``harness/check.py::Reference``);
* ``NORM_PARAMS``, ``shapes(m)``: every weight under its Hugging Face name,
  in draw order (``harness/weights.py``);
* ``TINY[role]``: the sizes and model id of a CPU rehearsal
  (``harness/chat.py::tiny_config``);
* ``flops(m, seq_lens)``, ``seq_len(n_a, n_b, max_length)``: the forward
  operations over real token counts, and a query's or a pair's token count
  (``harness/readers.py::serve_flops``);
* ``check_program(m, role, cfg)``, ``program_state(cfg, weights)``,
  ``program_model(cfg, weights, device, dtype)``: the program seated with
  the benchmark's weights (``harness/chat.py::seat_weights``,
  ``tools/calibrate.py::reseat``).
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

from .common import BENCH_DIR

DIR = BENCH_DIR / "families"


@functools.lru_cache(maxsize=None)
def load_all(directory: Path) -> dict:
    """name -> module of every family file in ``directory``."""
    out = {}
    for path in sorted(directory.glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"bench_family_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def family(m: dict):
    """The one family whose ``ARCHITECTURES`` hold ``m["architectures"]``."""
    fams = load_all(DIR)
    arch = m.get("architectures")
    found = [mod for mod in fams.values() if arch in mod.ARCHITECTURES]
    if len(found) != 1:
        known = "; ".join(f"{name}: {', '.join(mod.ARCHITECTURES)}" for name, mod in fams.items())
        raise ValueError(f"{len(found)} model families serve architectures {arch!r} (known families: {known})")
    return found[0]
