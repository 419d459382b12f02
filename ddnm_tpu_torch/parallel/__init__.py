"""Parallelism of the port (ddnm_tpu/parallel): a 1-D data mesh of
devices with the weights replicated and the image batch sharded
(mesh.py), several processes each restoring a slice of the dataset
(multihost.py), and spatial partitioning, a (data, spatial) grid of
processes whose UNets each hold a block of every tile's rows (spatial.py:
`make_mesh_2d` with sp > 1; halo.py, the convolutions' halo rows).
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
from ddnm_tpu_torch.parallel.spatial import (
    BACKWARD_COLLECTIVES,
    COLLECTIVES,
    SPATIAL_AXIS,
    Grid,
    SpatialGroup,
    gather_rows,
    gather_shards,
    grid_sampler,
    make_mesh_2d,
    reset_collective_counts,
    shard_tiles,
    split_rows,
    sum_replicated,
)

__all__ = [
    "BACKWARD_COLLECTIVES",
    "COLLECTIVES",
    "DATA_AXIS",
    "Grid",
    "SpatialGroup",
    "gather_rows",
    "gather_shards",
    "grid_sampler",
    "reset_collective_counts",
    "split_rows",
    "sum_replicated",
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
