"""Model weights from ``--seed``, made on the device in the served dtype.

The role entry's family (``harness/families.py``) names every tensor and its
shape under the Hugging Face names that the program's loader and the plain
reference read. One normal draw fills a flat bf16 buffer with every dense
weight, bias and table (N(0, 0.02), or the model's ``init_std``); a second
fills the norms in order, each norm's parameters (the family's
``NORM_PARAMS``) one after the other: the gain first (1 + N(0, 0.02)), then
any shift (N(0, 0.02)).
"""

from __future__ import annotations

from .families import family

ROLE_SALT = {"embedder": 0x3C6EF372, "reranker": 0x5BE0CD19}


def role_seed(seed: int, role: str) -> int:
    return (int(seed) * 2654435761 + ROLE_SALT[role]) % (1 << 63)


def make_weights(m: dict, seed: int, device, dtype=None) -> dict:
    """name -> tensor on ``device`` (bf16 unless ``dtype``) of the model
    ``m`` (a configuration's ``embedder`` or ``reranker`` entry), drawn from
    ``seed`` in two large calls."""
    import math

    import torch

    fam = family(m)
    dtype = dtype or torch.bfloat16
    dense, norms = fam.shapes(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for _, s in dense]
    std = m.get("init_std", 0.02)
    flat = torch.empty(sum(sizes), dtype=torch.bfloat16, device=device).normal_(0.0, std, generator=gen)
    k = len(fam.NORM_PARAMS)
    widths = [k * math.prod(s) for _, s in norms]
    ln = torch.empty(sum(widths), dtype=torch.bfloat16, device=device).normal_(0.0, 0.02, generator=gen)
    out, at = {}, 0
    for (name, shape), n in zip(dense, sizes):
        out[name] = flat[at: at + n].view(shape)
        at += n
    at = 0
    for (name, shape), n in zip(norms, widths):
        params = ln[at: at + n].view(k, *shape)
        params[0] += 1.0
        for param, value in zip(fam.NORM_PARAMS, params):
            out[f"{name}.{param}"] = value
        at += n
    if dtype != torch.bfloat16:
        out = {name: v.to(dtype) for name, v in out.items()}
    return out
