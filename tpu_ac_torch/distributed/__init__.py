"""Data-parallel mesh and the sharded alpha (port of
``tpu_ac.distributed``): one process drives every device of a ``Mesh``,
which may repeat a device (see ``mesh.py``); training across processes
joins a ``torch.distributed`` group (``multihost_init``) and reduces
through ``collectives.py``."""

from tpu_ac_torch.distributed.mesh import (
    Mesh,
    dp_mesh,
    get_mesh,
    multihost_init,
    process_count,
    process_index,
    replicate,
    shard_batch,
    sharded_weight_distance_supervised,
    sharded_weight_distance_unsupervised,
    triangle_weights_local,
)

__all__ = [
    "Mesh",
    "get_mesh",
    "dp_mesh",
    "multihost_init",
    "process_count",
    "process_index",
    "shard_batch",
    "replicate",
    "sharded_weight_distance_unsupervised",
    "sharded_weight_distance_supervised",
    "triangle_weights_local",
]
