"""Parallelism of the port (ddnm_tpu/parallel's data half): a 1-D data
mesh of devices with the weights replicated and the image batch sharded
(mesh.py), and several processes each restoring a slice of the dataset
(multihost.py). Spatial partitioning (spatial.py: `make_mesh_2d` with
sp > 1) is not ported yet.
"""

from ddnm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    Replicas,
    make_mesh,
    replicate,
    replicate_all,
    shard_batch,
    sharded_sampler,
)
from ddnm_tpu_torch.parallel.multihost import (
    local_device,
    maybe_init_distributed,
    process_count,
    process_index,
    process_subset,
)
from ddnm_tpu_torch.parallel.spatial import SPATIAL_AXIS, make_mesh_2d, shard_tiles

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "Replicas",
    "SPATIAL_AXIS",
    "local_device",
    "make_mesh",
    "make_mesh_2d",
    "maybe_init_distributed",
    "process_count",
    "process_index",
    "process_subset",
    "replicate",
    "replicate_all",
    "shard_batch",
    "shard_tiles",
    "sharded_sampler",
]
