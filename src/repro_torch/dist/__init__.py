"""Distribution layer: platform meshes + logical-axis sharding rules.

The image's MESH layer names a *platform* (local / cpu / pod / multipod);
the container resolves it to this rank's view of the job's mesh here.
Model code never sees the mesh -- it annotates tensors with logical axis
names, and the rules in ``dist.sharding`` translate those names into mesh
specs. (The JAX package's ``dist/compat.py``, a ``shard_map`` version
shim, has no counterpart: the port's ranks are processes.)
"""

from repro_torch.dist.mesh import (PLATFORMS, PlatformMesh, batch_axes,
                                   make_mesh, make_platform_mesh,
                                   resolve_device)
from repro_torch.dist.sharding import (
    NamedSharding,
    ShardingRules,
    check_divisibility,
    constrain,
    logical_sharding,
    safe_spec,
)

__all__ = [
    "PLATFORMS",
    "PlatformMesh",
    "batch_axes",
    "make_mesh",
    "make_platform_mesh",
    "resolve_device",
    "NamedSharding",
    "ShardingRules",
    "check_divisibility",
    "constrain",
    "logical_sharding",
    "safe_spec",
]
