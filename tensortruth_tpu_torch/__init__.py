"""tensortruth_tpu_torch: the engine's online query path and its capacity tiers
(int8 corpus, IVF) in PyTorch + CUDA.

A port of ``tensortruth_tpu`` (the JAX/Pallas reference, which stays beside
it) to PyTorch on NVIDIA Hopper. Plain tensor code is PyTorch; each TPU
kernel is a hand-written CUDA C++ kernel under ``csrc/``, built with nvcc at
first use (``_build.py``). The host modules (index store and chunker,
tokenizer and its C++ hostkit, config, prompts, chat history, batcher) are
this package's own copies of the reference's, with the same on-disk formats
and environment variables, so one index directory and one config file serve
both. No module here imports jax or the reference package.
"""

__version__ = "0.1.0"
