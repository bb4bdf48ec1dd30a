"""Runtime facade: docker-CLI-shaped operations over images + containers.

    rt = Runtime(root)                         # ~/.stevedore analog
    img = rt.build(imagefile_text, tag="stable")
    c = rt.run("stable")                       # -> Container on cuda:0
    c = rt.run("stable", platform="cpu")       # the host CPU, when asked
    rt.images(); rt.ps()

The Runtime owns the registry, the in-memory compile cache (shared by every
container it runs) and the overlay root.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.container import Container
from repro_torch.core.image import EnvImage
from repro_torch.core.imagefile import parse_imagefile
from repro_torch.core.registry import Registry, TransferStats


class Runtime:
    def __init__(self, root: str | os.PathLike = ".stevedore"):
        self.root = Path(root)
        self.registry = Registry(self.root / "registry")
        self.compile_cache = CompileCache()
        self.overlay_root = self.root / "overlays"

    # -- images ------------------------------------------------------------
    def build(self, imagefile_text: str, tag: str | None = None) -> EnvImage:
        image = parse_imagefile(imagefile_text, registry=self.registry)
        self.registry.push(image, tag=tag)
        return image

    def push(self, image: EnvImage, tag: str | None = None) -> TransferStats:
        return self.registry.push(image, tag)

    def pull(self, ref: str) -> EnvImage:
        return self.registry.pull(ref)

    def images(self) -> list[dict]:
        tags = self.registry.tags()
        by_digest: dict[str, list[str]] = {}
        for t, d in tags.items():
            by_digest.setdefault(d, []).append(t)
        return [
            {"digest": d[:12], "tags": sorted(by_digest.get(d, []))}
            for d in self.registry.images()
        ]

    # -- containers --------------------------------------------------------
    def run(self, ref_or_image, platform: str | None = None,
            mesh=None) -> Container:
        """A Container of the image on ``platform``; ``mesh`` (a
        ``dist.mesh.PlatformMesh`` of this job) replaces the platform's."""
        image = (ref_or_image if isinstance(ref_or_image, EnvImage)
                 else self.pull(ref_or_image))
        c = Container(image, platform=platform,
                      overlay_root=self.overlay_root,
                      compile_cache=self.compile_cache, mesh=mesh)
        c.ensure_overlay()
        return c

    def ps(self) -> list[dict]:
        out = []
        if self.overlay_root.exists():
            for d in sorted(self.overlay_root.iterdir()):
                meta = d / "container.json"
                if meta.exists():
                    rec = json.loads(meta.read_text())
                    rec["id"] = d.name
                    out.append(rec)
        return out
