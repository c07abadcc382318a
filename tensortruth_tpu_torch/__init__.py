"""tensortruth_tpu_torch: the engine's online query path and its capacity tiers
(int8 corpus, IVF) in PyTorch + CUDA.

A port of ``tensortruth_tpu`` (the JAX/Pallas reference, which stays beside
it) to PyTorch on NVIDIA Hopper. Plain tensor code is PyTorch; each TPU
kernel on these paths is a hand-written CUDA C++ kernel under ``csrc/``, built
with nvcc at first use (``_build.py``). Host modules of the reference that
never import jax (index store, tokenizer, config, prompts, chat history) are
shared, not copied. No module here imports jax.
"""

__version__ = "0.1.0"
