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

# The multi-process global mesh (parallel/distributed.py) is imported by the
# deployments that form a torch.distributed world; importing it here would
# load the distributed runtime into every single-process user.
