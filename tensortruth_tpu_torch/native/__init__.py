"""First-party native (C++) host runtime components.

The TPU compute path is JAX/XLA/Pallas; this package holds the host-side
pieces that sit on the serving critical path and benefit from native code
— currently the batch tokenizer / rerank-pair shaper (hostkit.cpp),
the first-party equivalent of the Rust ``tokenizers`` dependency the
reference leans on (SURVEY.md §0 "Tokenization" row).

Everything here is optional: callers use :func:`hostkit.get_hostkit` and
fall back to the pure-Python implementation when no C++ toolchain is
available.
"""

from tensortruth_tpu_torch.native.hostkit import get_hostkit  # noqa: F401
