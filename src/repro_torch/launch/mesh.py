"""Production meshes for the multi-pod dry-run (the port of
``repro.launch.mesh``).

A FUNCTION, not a module-level constant. The mesh holds the shape and axis
names and no process or device: it is what the dry-run and the analysis
tools lower onto, and no job of that size runs here.
"""

from __future__ import annotations

from repro_torch.dist.mesh import PlatformMesh


def make_production_mesh(*, multi_pod: bool = False) -> PlatformMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return PlatformMesh(axes, shape)
