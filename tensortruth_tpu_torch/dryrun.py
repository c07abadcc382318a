"""Multi-device dry run of the query step: the port's counterpart of
``__graft_entry__.py::dryrun_multichip``.

    python -m tensortruth_tpu_torch.dryrun 8        # over the CUDA cards

:func:`dryrun_multidevice` runs the reference's ``_dryrun_payload`` query
step at tiny width on a 2 x (n/2) mesh (1 x n for odd n): the query batch
embedded data-parallel, a row-sharded top-k with its candidates merged, the
cluster-sharded IVF search, and the cross-encoder rerank of the (query,
chunk) pairs data-parallel. The reference's multislice stages (socket-routed
cluster groups) are not ported yet and are left out. Each data-parallel
batch is padded to a multiple of the mesh size (the port's DP forwards split
it over every slot). ``devices`` may repeat a device to place several slots
on it; by default the mesh spans every CUDA card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tensortruth_tpu_torch.models.embedder import make_dp_forward
from tensortruth_tpu_torch.models.xlmr import XLMRConfig, XLMRModel, cls_embed, rerank_logits
from tensortruth_tpu_torch.ops.ivf import build_ivf, ivf_search_sharded, shard_ivf
from tensortruth_tpu_torch.parallel.mesh import DATA_AXIS, local_devices, make_mesh
from tensortruth_tpu_torch.parallel.sharded_topk import shard_corpus, sharded_topk
from tensortruth_tpu_torch.tokenization import load_tokenizer

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position=130)


def _pad_rows(x: np.ndarray, multiple: int) -> np.ndarray:
    return np.pad(x, ((0, -len(x) % multiple), (0, 0)))


def dryrun_multidevice(n_devices: int, devices: list | None = None) -> dict:
    """Run the query step on an ``n_devices`` mesh; returns what each stage
    produced (shapes and the mesh). Raises on any stage that fails."""
    devices = list(devices if devices is not None else local_devices())[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"dry run needs {n_devices} devices, have {len(devices)}")
    n_data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_shards=n_devices // n_data, n_data=n_data, devices=devices)
    cfg, rcfg = XLMRConfig(**TINY), XLMRConfig(**TINY, num_labels=1)
    embed, multiple = make_dp_forward(cls_embed, XLMRModel.random_init(cfg, mesh.lead, seed=0), mesh)
    rerank, _ = make_dp_forward(rerank_logits, XLMRModel.random_init(rcfg, mesh.lead, seed=1), mesh)
    b, s, k = 2 * n_data, 16, 4
    out = {"mesh": mesh.shape}

    with torch.inference_mode():
        # stage 1: query encoding, data-parallel
        ones = _pad_rows(np.ones((b, s), np.int32), multiple)
        q = embed(ones, ones)[:b].float()
        if q.shape != (b, cfg.hidden_size):
            raise RuntimeError(f"DP embed gave {tuple(q.shape)}")

        # stage 2: row-sharded top-k, candidates merged on the lead device
        rng = np.random.default_rng(0)
        corpus = rng.standard_normal((64, cfg.hidden_size)).astype(np.float32)
        corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
        emb, n_actual = shard_corpus(corpus, mesh)
        vals, idx = sharded_topk(q, emb, k=k, n_actual=n_actual, q_sharded=b % mesh.shape[DATA_AXIS] == 0)
        if idx.shape != (b, k) or int(idx.max()) >= n_actual:
            raise RuntimeError(f"sharded top-k gave ids {idx.tolist()}")

        # stage 2b: the cluster-sharded IVF search
        big = rng.standard_normal((256, cfg.hidden_size)).astype(np.float32)
        big /= np.linalg.norm(big, axis=1, keepdims=True)
        ivf = build_ivf(big, n_clusters=8, sample_size=256, device=mesh.lead, device_blocks=False)
        ivf_vals, ivf_rows = ivf_search_sharded(shard_ivf(ivf, mesh), q, k, nprobe=2)
        if ivf_rows.shape != (b, k) or int(ivf_rows.max()) >= 256:
            raise RuntimeError(f"sharded IVF gave rows {ivf_rows.tolist()}")

        # stage 3: cross-encoder rerank of the (query, chunk) pairs, data-parallel
        tok = load_tokenizer()
        texts = [f"chunk {i} body words for the rerank pair" for i in range(64)]
        firsts = [f"query {qi}" for qi in range(b) for _ in range(k)]
        seconds = [texts[int(r) % len(texts)] for r in idx.flatten().tolist()]
        ids, mask = tok.encode_batch(firsts, s, pair=seconds)
        logits = rerank(_pad_rows(ids % rcfg.vocab_size, multiple).astype(np.int32),
                        _pad_rows(mask, multiple).astype(np.int32))
        if logits.shape[0] < b * k or not torch.isfinite(logits).all():
            raise RuntimeError("DP rerank gave no finite logit per pair")
    out.update(embed=tuple(q.shape), topk=tuple(idx.shape), ivf=ivf_rows.shape, pairs=b * k,
               rerank_batch=logits.shape[0])
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    print(f"dryrun_multidevice OK: {dryrun_multidevice(n)}")
