from tensortruth_tpu_torch.parallel.mesh import DATA_AXIS, SHARD_AXIS, Mesh, make_mesh
from tensortruth_tpu_torch.parallel.sharded_topk import ShardedCorpus, shard_corpus, sharded_topk

__all__ = [
    "DATA_AXIS",
    "SHARD_AXIS",
    "Mesh",
    "ShardedCorpus",
    "make_mesh",
    "shard_corpus",
    "sharded_topk",
]

# The multi-process paths are imported lazily by the deployments that use
# them: the global mesh (parallel/distributed.py) by those that form a
# torch.distributed world, and the multi-slice tier (parallel/multislice.py:
# host-routed IVF cluster groups, in process or in slice-worker processes
# over parallel/transport.py) by those past one device's memory. Importing
# them here would load the distributed runtime and the socket transport into
# every single-process user.
