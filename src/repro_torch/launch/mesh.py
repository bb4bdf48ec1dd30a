"""Production meshes for the multi-pod dry-run (the port of
``repro.launch.mesh``).

Functions, not module-level constants. ``make_production_mesh`` holds the
shape and axis names and no process or device: what the analysis tools
lay specs onto. ``fake_platform_mesh`` is a platform's mesh seen from rank
0 of a job of fake ranks (``dist.mesh.fake_job``), with its process
groups: what the dry run traces one rank's step on.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

from repro_torch.dist.mesh import (PLATFORMS, PlatformMesh, fake_job,
                                   make_platform_mesh)


def make_production_mesh(*, multi_pod: bool = False) -> PlatformMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return PlatformMesh(axes, shape)


@contextmanager
def fake_platform_mesh(platform: str):
    """``platform``'s mesh as rank 0 of a job of as many fake ranks as it
    has (``pod`` 256, ``multipod`` 512; ``local``: one rank, no job), for
    the length of the block."""
    shape = PLATFORMS[platform]["shape"] if platform in PLATFORMS else None
    if shape is None:
        yield make_platform_mesh(platform)
        return
    with fake_job(math.prod(shape)):
        yield make_platform_mesh(platform)
