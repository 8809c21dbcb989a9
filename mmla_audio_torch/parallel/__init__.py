"""See the counterpart subpackage of ``mmla_audio_tpu``: data parallelism
(one process's cards, or ``torch.distributed``) and, for training across
processes, parameters and optimizer state split over the mesh's model axis
(``param_shardings``, ``shard_params``, ``distributed.global_mesh(n_model=)``)."""

from mmla_audio_torch.parallel import distributed
from mmla_audio_torch.parallel.mesh import (
    DataParallel,
    Mesh,
    ShardedBatch,
    Sharding,
    batch_sharding,
    make_mesh,
    param_shardings,
    replicate_tree,
    replicated,
    shard_batch,
    shard_params,
)

__all__ = [
    "DataParallel",
    "Mesh",
    "ShardedBatch",
    "Sharding",
    "batch_sharding",
    "distributed",
    "make_mesh",
    "param_shardings",
    "replicate_tree",
    "replicated",
    "shard_batch",
    "shard_params",
]
