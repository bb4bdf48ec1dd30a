"""Registry: content-addressed image store with tags (paper §2.2, §3.4).

Mirrors quay.io / Docker Hub mechanics:

* ``layers/<digest>``  -- one JSON blob per layer, stored once no matter how
  many images reference it (the layered-FS dedupe of §2.2);
* ``images/<digest>``  -- manifest: ordered list of layer digests;
* ``tags/<name>``      -- mutable pointer to an image digest
  (``stable`` / ``dev`` / ``2016.1.0r1`` style tags, §3.4).

``push``/``pull`` return transfer stats so tests (and the fig2 benchmark) can
assert the dedupe property: pushing a derived image moves only its new layers.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from pathlib import Path

from repro_torch.core.image import EnvImage, Layer

_TAG_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._\-/]*$")
_HEX_RE = re.compile(r"^[0-9a-f]{12,64}$")


@dataclass(frozen=True)
class TransferStats:
    """Bytes/objects moved vs reused -- the layer-dedupe receipt."""

    layers_total: int
    layers_transferred: int
    layers_reused: int
    bytes_transferred: int

    @property
    def dedupe_fraction(self) -> float:
        return self.layers_reused / max(1, self.layers_total)


class RegistryError(KeyError):
    pass


class Registry:
    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        for sub in ("layers", "images", "tags"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)

    # -- push ------------------------------------------------------------
    def push(self, image: EnvImage, tag: str | None = None) -> TransferStats:
        transferred = reused = nbytes = 0
        for layer in image.layers:
            p = self.root / "layers" / layer.digest
            if p.exists():
                reused += 1
            else:
                blob = layer.to_json()
                _atomic_write(p, blob)
                transferred += 1
                nbytes += len(blob)
        manifest = json.dumps([l.digest for l in image.layers])
        mp = self.root / "images" / image.digest
        if not mp.exists():
            _atomic_write(mp, manifest)
            nbytes += len(manifest)
        if tag is not None:
            self.tag(image.digest, tag)
        return TransferStats(len(image.layers), transferred, reused, nbytes)

    # -- pull ------------------------------------------------------------
    def pull(self, ref: str) -> EnvImage:
        digest = self.resolve(ref)
        mp = self.root / "images" / digest
        if not mp.exists():
            raise RegistryError(f"image {ref!r} ({digest[:12]}) not in registry")
        layer_digests = json.loads(mp.read_text())
        layers = []
        for ld in layer_digests:
            lp = self.root / "layers" / ld
            if not lp.exists():
                raise RegistryError(f"corrupt registry: missing layer {ld[:12]}")
            layer = Layer.from_json(lp.read_text())
            if layer.digest != ld:
                raise RegistryError(f"content-hash mismatch for layer {ld[:12]}")
            layers.append(layer)
        image = EnvImage(tuple(layers))
        if image.digest != digest:
            raise RegistryError(f"content-hash mismatch for image {digest[:12]}")
        return image

    # -- tags --------------------------------------------------------------
    def tag(self, digest_or_ref: str, tag: str) -> None:
        if not _TAG_RE.match(tag):
            raise ValueError(f"bad tag {tag!r}")
        digest = self.resolve(digest_or_ref)
        _atomic_write(self.root / "tags" / tag.replace("/", "__"), digest)

    def resolve(self, ref: str) -> str:
        """tag | full digest | unique digest prefix -> full digest."""
        tp = self.root / "tags" / ref.replace("/", "__")
        if tp.exists():
            return tp.read_text().strip()
        if _HEX_RE.match(ref):
            hits = [p.name for p in (self.root / "images").iterdir() if p.name.startswith(ref)]
            if len(hits) == 1:
                return hits[0]
            if len(hits) > 1:
                raise RegistryError(f"ambiguous digest prefix {ref!r}")
        raise RegistryError(f"unknown ref {ref!r}")

    def tags(self) -> dict[str, str]:
        return {
            p.name.replace("__", "/"): p.read_text().strip()
            for p in (self.root / "tags").iterdir()
        }

    def images(self) -> list[str]:
        return sorted(p.name for p in (self.root / "images").iterdir())

    def layer_count(self) -> int:
        return sum(1 for _ in (self.root / "layers").iterdir())


def _atomic_write(path: Path, text: str) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)
