"""setup_engine_s: seconds of the engine's cold loads in set-up
(``engine.py::load_engine_for_modules``: index read, models, placement),
from the program's set-up account before the window
(``harness/setup_parts.py``). Program counter, host clock."""
from benchmark_torch.harness import setup_parts


def read(ctx):
    parts = setup_parts.parts(ctx)
    return None if parts is None else parts["engine"]
