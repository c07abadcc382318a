"""Device mesh: an ``(n_data, n_shards)`` grid of torch devices.

Port of ``tensortruth_tpu/parallel/mesh.py``. The reference's
``jax.sharding.Mesh`` is single-controller: one process drives every local
chip. Its counterpart here is a plain grid of ``torch.device`` objects, not
``torch.distributed.DeviceMesh`` (which needs a process group per process):

* axis ``shards``: rows of the corpus (or IVF clusters) are split over the
  columns; each shard's work is launched on its column's devices and the
  small per-shard candidates are merged on the mesh's lead device;
* axis ``data``: query and pair batches are split over every slot of the
  grid for data-parallel encoder and reranker forwards.

A device may appear in several slots (``make_mesh(devices=["cuda:0"] * 8)``),
the counterpart of XLA's virtual CPU devices: the CPU tests and a one-card
run place every shard on one device, and a shard's replicas that sit on the
same device share one buffer. The reference's ``NamedSharding`` helpers
(``row_sharded``, ``replicated``, ``batch_sharded``) have no torch
counterpart; :meth:`Mesh.shard_devices` takes their place.

A mesh over several processes (``parallel/distributed.py::global_mesh``)
holds ``None`` in the slots other processes own, and ``ranks`` says which
process owns each slot.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

SHARD_AXIS = "shards"  # corpus-row sharding (retrieval fan-out)
DATA_AXIS = "data"  # batch sharding (encoder/reranker DP)


def local_devices() -> list[torch.device]:
    """Every CUDA card of this process, in index order (none without CUDA)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def canonical(device) -> torch.device:
    """``device`` as a ``torch.device``, a card with its index (``cuda`` is
    the current card), so one card is one device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def on(device: torch.device):
    """Make ``device`` current for the launches in the block (CUDA only:
    a kernel launch goes to the current card)."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


class Mesh:
    """``grid[d][s]``: the device of data row ``d``, shard ``s`` (``None`` in
    a slot another process owns); ``ranks[d][s]``: the process that owns
    it."""

    def __init__(self, grid: list[list[torch.device | None]], ranks: list[list[int]] | None = None, rank: int = 0):
        self.grid = [list(row) for row in grid]
        self.ranks = ranks if ranks is not None else [[0] * len(row) for row in grid]
        self.rank = rank
        if not self.flat:
            raise ValueError("a mesh needs at least one device of this process")

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.grid), SHARD_AXIS: len(self.grid[0])}

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    @property
    def flat(self) -> list[torch.device]:
        """This process's slots in row-major order (the DP batch order)."""
        return [d for row in self.grid for d in row if d is not None]

    @property
    def lead(self) -> torch.device:
        """Where candidates merge and results land: the first slot's device."""
        return self.flat[0]

    @property
    def distinct(self) -> list[torch.device]:
        """This process's devices, each once, in slot order."""
        return list(dict.fromkeys(self.flat))

    def shard_devices(self, s: int) -> list[torch.device]:
        """The distinct devices of this process that hold shard ``s``, in
        data-row order (empty for a shard only other processes hold)."""
        return list(dict.fromkeys(row[s] for row in self.grid if row[s] is not None))

    def describe(self) -> tuple:
        """A value identity: the shape and each slot's device (or owner)."""
        slots = tuple(str(d) if d is not None else f"rank{r}" for row, rr in zip(self.grid, self.ranks)
                      for d, r in zip(row, rr))
        return tuple(sorted(self.shape.items())), slots

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat]})"


def make_mesh(n_shards: int | None = None, n_data: int = 1, devices: list | None = None) -> Mesh:
    """Build a (data, shards) mesh over ``devices`` (default: every CUDA
    card; never the CPU unless the caller lists it). The first
    ``n_data * n_shards`` devices fill the grid row by row; ``n_shards``
    defaults to all of them over ``n_data`` rows. Raises when there are too
    few devices."""
    devices = [canonical(d) for d in (devices if devices is not None else local_devices())]
    if not devices:
        raise ValueError("no device to build a mesh over: no CUDA card, and no devices= given")
    if n_shards is None:
        n_shards = len(devices) // n_data
    use = n_data * n_shards
    if use < 1 or use > len(devices):
        raise ValueError(f"mesh {n_data}x{n_shards} needs {max(use, 1)} devices, have {len(devices)}")
    return Mesh([devices[r * n_shards : (r + 1) * n_shards] for r in range(n_data)])
