"""Dense embedder runtime: tokenize -> sort by length -> bucket -> forward.

Port of ``tensortruth_tpu/models/embedder.py``. Texts are tokenized once per
slab, sorted longest first so each device batch pads to the tightest
(batch, seq) bucket, and every batch of a slab is launched before the
previous slab's embeddings come back to the host in ONE device-to-host copy.

Nothing here synchronises the CUDA stream: token ids go up through pinned
staging with non-blocking copies (:func:`upload`), and each slab's
embeddings come down into pinned memory behind a CUDA event that the host
waits on only when it drains that slab, one slab behind the launch front.

On a mesh (``Embedder(mesh=...)``, :func:`make_dp_forward`) every forward is
data-parallel over the mesh's slots, and the batch bucket rounds up to a
multiple of the mesh size, as the reference's does.

The bucket sets are the reference's, tuned on a TPU and not yet re-measured
on the H100.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tensortruth_tpu_torch.models.xlmr import XLMRConfig, XLMRModel, cls_embed, use_approx_gelu
from tensortruth_tpu_torch.parallel.mesh import on


def bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value (the largest if none is)."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``. On a CUDA device the copy is
    staged in pinned memory and queued without a stream synchronise (a
    blocking host-to-device copy waits for all the work queued before it);
    PyTorch's caching host allocator keeps the pinned block until the copy
    has run. On the CPU it is the plain conversion."""
    t = torch.from_numpy(x)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_host_async(x: torch.Tensor):
    """Queue the copy of ``x`` to the host and return ``wait() -> ndarray``.
    A CUDA tensor lands in pinned memory behind an event, and ``wait`` blocks
    on that event alone; a CPU tensor is returned as it is."""
    if not x.is_cuda:
        return x.numpy
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(x.device))

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return wait


def make_dp_forward(fn, model: XLMRModel, mesh=None):
    """``(forward(*host arrays) -> tensor, batch multiple)`` for
    ``fn(model, *device arrays)``.

    Without a mesh: one forward on the model's device. On a mesh the
    parameters are replicated once per distinct device (the model itself
    serves its own device), the batch (a multiple of the mesh size) splits
    into one slice per slot, each slice is forwarded on its slot's device,
    and the outputs are gathered on the lead device. Nothing waits for the
    device between the launches: the slices go up through pinned memory
    (:func:`upload`) and the gathers are device copies."""
    if mesh is None:
        dev = model.device
        return (lambda *arrays: fn(model, *(upload(a, dev) for a in arrays))), 1
    replicas = {d: model if d == model.device else model.replicate(d) for d in mesh.distinct}
    slots = [replicas[d] for d in mesh.flat]
    lead = mesh.lead

    def forward(*arrays):
        per = arrays[0].shape[0] // len(slots)
        outs = []
        for i, replica in enumerate(slots):
            dev = replica.device
            with on(dev):
                outs.append(fn(replica, *(upload(a[i * per : (i + 1) * per], dev) for a in arrays)))
        return torch.cat([o.to(lead, non_blocking=True) for o in outs])

    return forward, len(slots)


def pad_batch(ids: np.ndarray, mask: np.ndarray, sel: np.ndarray, bsz: int, seq: int, pad_id: int):
    """Rows ``sel`` of (ids, mask) cut to ``seq`` and padded to ``bsz`` rows."""
    ids_p = np.full((bsz, seq), pad_id, dtype=np.int32)
    mask_p = np.zeros((bsz, seq), dtype=np.int32)
    ids_p[: len(sel)] = ids[sel, :seq]
    mask_p[: len(sel)] = mask[sel, :seq]
    return ids_p, mask_p


class Embedder:
    """Holds the encoder on its device (or replicated over a mesh, the
    model on its lead device); encodes host-side text."""

    def __init__(
        self,
        model: XLMRModel,
        tokenizer,
        max_length: int = 2048,
        batch_buckets: Sequence[int] = (16, 64, 256),
        seq_buckets: Sequence[int] = (128, 256, 384, 512, 1024, 2048),
        query_prefix: str = "",
        mesh=None,
    ):
        self.model = model
        self.cfg: XLMRConfig = model.cfg
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.seq_buckets = tuple(sorted(set(min(b, max_length) for b in seq_buckets)))
        self.query_prefix = query_prefix
        self.mesh = mesh
        self._fwd, self._batch_multiple = make_dp_forward(cls_embed, model, mesh)

    @classmethod
    def random_init(
        cls, cfg: XLMRConfig, tokenizer, device, dtype=torch.bfloat16, seed: int = 0, **kw
    ) -> "Embedder":
        """Random weights at the configured width (no checkpoint on disk)."""
        return cls(XLMRModel.random_init(cfg, device, dtype=dtype, seed=seed), tokenizer, **kw)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def dim(self) -> int:
        return self.cfg.hidden_size

    @property
    def gelu_flavor(self) -> str:
        """"tanh" or "exact": recorded in index metadata at build time so a
        query-side mismatch is detectable at engine load."""
        return "tanh" if use_approx_gelu(self.cfg) else "exact"

    def param_bytes(self) -> int:
        return self.model.param_bytes()

    def to_device(self, ids_p: np.ndarray, mask_p: np.ndarray):
        dev = self.device
        return upload(ids_p, dev), upload(mask_p, dev)

    def encode(
        self, texts: Sequence[str], is_query: bool = False, batch_size: int | None = None
    ) -> np.ndarray:
        """Embed texts -> (len(texts), H) f32 L2-normalised numpy array."""
        if not texts:
            return np.zeros((0, self.cfg.hidden_size), dtype=np.float32)
        if is_query and self.query_prefix:
            texts = [self.query_prefix + t for t in texts]

        max_batch = min(batch_size or self.batch_buckets[-1], self.batch_buckets[-1])
        slab = max(8 * max_batch, 2048)
        out = np.empty((len(texts), self.cfg.hidden_size), dtype=np.float32)
        prev = None  # (global row selection, wait for its host embeddings) of the last slab
        with torch.inference_mode():
            for slab_start in range(0, len(texts), slab):
                chunk = list(texts[slab_start : slab_start + slab])
                ids, mask = self.tokenizer.encode_batch(chunk, self.max_length)
                lengths = mask.sum(axis=1)
                order = np.argsort(-lengths, kind="stable")  # longest first
                sels, embs = [], []
                for start in range(0, len(chunk), max_batch):
                    sel = order[start : start + max_batch]
                    seq = bucket(int(lengths[sel].max()), self.seq_buckets)
                    bsz = bucket(len(sel), self.batch_buckets)
                    bsz = -(-bsz // self._batch_multiple) * self._batch_multiple  # DP
                    ids_p, mask_p = pad_batch(ids, mask, sel, bsz, seq, self.tokenizer.pad_id)
                    embs.append(self._fwd(ids_p, mask_p)[: len(sel)])
                    sels.append(slab_start + sel)
                # Drain one slab behind the launch front: the current slab is
                # queued on the device (its copy back behind it) while the
                # host waits for the previous one's copy alone.
                cur = (np.concatenate(sels), to_host_async(torch.cat(embs)))
                if prev is not None:
                    out[prev[0]] = prev[1]()
                prev = cur
            out[prev[0]] = prev[1]()
        return out

    def encode_one(self, text: str, is_query: bool = True) -> np.ndarray:
        return self.encode([text], is_query=is_query)[0]
