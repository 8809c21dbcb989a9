"""See the counterpart subpackage of ``mmla_audio_tpu``: data parallelism
only (no ``param_shardings``/``shard_params``)."""

from mmla_audio_torch.parallel import distributed
from mmla_audio_torch.parallel.mesh import (
    DataParallel,
    Mesh,
    ShardedBatch,
    Sharding,
    batch_sharding,
    make_mesh,
    replicate_tree,
    replicated,
    shard_batch,
)

__all__ = [
    "DataParallel",
    "Mesh",
    "ShardedBatch",
    "Sharding",
    "batch_sharding",
    "distributed",
    "make_mesh",
    "replicate_tree",
    "replicated",
    "shard_batch",
]
