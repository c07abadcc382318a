"""setup_models_s: seconds of the model loads inside the engine's cold loads
(``ModelManager._load`` for the embedder and the reranker: tokenizer,
weights drawn and seated, and the kernel library's first load where it
falls there), from the program's set-up account before the window
(``harness/setup_parts.py``). Program counter, host clock."""
from benchmark_torch.harness import setup_parts


def read(ctx):
    return setup_parts.total(ctx, "models_s")
