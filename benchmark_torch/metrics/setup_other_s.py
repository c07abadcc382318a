"""setup_other_s: ``setup_s`` less ``setup_engine_s`` and
``setup_served_s``: imports, the corpus check (on a checkout's first run
the corpus write), ``create_app``, server start, the load process and, in a
traced run, the profiler's preparation (``harness/setup_parts.py``). Host
clock and program counter."""
from benchmark_torch.harness import setup_parts


def read(ctx):
    parts = setup_parts.parts(ctx)
    return None if parts is None else parts["other"]
