"""The 2-D (data, spatial) mesh of the JAX package's
ddnm_tpu/parallel/spatial.py, data half only.

Spatial partitioning (the image's H axis over a mesh axis, to cut the
latency of the hq pipeline's batch-1 tile chain) is not ported: in an
eager PyTorch program it needs halo exchanges in every 3x3 convolution,
GroupNorm statistics combined across shards before the affine, and
gathered attention (ROADMAP.md Queue 1 F, spatial). `make_mesh_2d` with
sp > 1 raises; with sp == 1 it is the data mesh. `shard_tiles` places a
tree on the data axis: a leaf whose leading axis divides is split, any
other is copied to every entry, with a warning once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ddnm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    _is_generators,
    make_mesh,
    shard_batch,
    to_device,
    warn_unsharded,
)

__all__ = ["SPATIAL_AXIS", "make_mesh_2d", "shard_tiles"]

SPATIAL_AXIS = "spatial"


def make_mesh_2d(dp: int, sp: int, devices: Optional[Sequence] = None, *,
                 device="cuda") -> Mesh:
    """The (dp x sp) mesh over the first dp * sp devices; only sp == 1 (the
    1-D data mesh of dp entries) is ported."""
    if sp > 1:
        raise NotImplementedError(
            f"the spatial mesh axis (sp={sp}) is not ported yet (ROADMAP.md Queue 1 F, "
            "spatial: halo exchanges, cross-shard GroupNorm statistics, gathered attention)")
    return make_mesh(dp, devices, device=device)


def shard_tiles(mesh: Mesh, tree):
    """Every leaf of `tree` as a tuple of per-entry values: the leading axis
    split over the data axis where the mesh size divides it, else the whole
    leaf on every entry's device (logged once per combination)."""
    if isinstance(tree, torch.Tensor) or _is_generators(tree):
        n = len(tree) if not isinstance(tree, torch.Tensor) or tree.ndim else 0
        if n and n % mesh.size == 0:
            return shard_batch(mesh, tree)
        if n:
            warn_unsharded(DATA_AXIS, mesh.size, n)
        return tuple(to_device(tree, d) for d in mesh.devices)
    if isinstance(tree, dict):
        return {k: shard_tiles(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tiles(mesh, v) for v in tree)
    return tree
