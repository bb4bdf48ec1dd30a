"""EnvImage: immutable, layered, content-addressed environment images.

Direct analog of the paper's Docker/OCI images (paper §2.1-2.2):

* an image is an ordered chain of *layers*; each layer stores only the
  difference (here: a config delta) relative to its parent;
* every layer and every image is identified by a sha256 content hash, so two
  images built from the same Imagefile prefix share layer objects byte-for-byte
  (the "layered file system" benefit of §2.2);
* images are immutable: runtime mutation happens in a Container's writable
  overlay (container.py), never in the image.

The merged-config semantics are "later layer wins", exactly like Docker's
union mount: the final environment is the left-fold of layer deltas.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping

# Layer kinds, in the spirit of Dockerfile directives.
LAYER_KINDS = (
    "base",         # FROM scratch: framework + format version pin
    "arch",         # ARCH: model architecture selection + overrides
    "shape",        # SHAPE: input-shape cell (train_4k / prefill_32k / ...)
    "mesh",         # MESH: platform / mesh layout selection
    "precision",    # PRECISION: param/compute/grad dtypes
    "collectives",  # COLLECTIVES: collective-ABI selection + options
    "set",          # SET: free-form runtime settings (remat, scan, ...)
    "label",        # LABEL: inert metadata (does not affect behaviour hash-wise
                    #        it still hashes -- images are bit-exact artifacts)
)


def canonical_json(obj: Any) -> str:
    """Deterministic JSON used for all content hashes."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"), default=_json_default)


def _json_default(o: Any):
    # tuples arrive as lists already; dataclasses / sets get normalised here.
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    raise TypeError(f"not canonically serialisable: {type(o)}")


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


@dataclass(frozen=True)
class Layer:
    """One immutable config delta. ``parent`` chains layers into an image."""

    kind: str
    payload: Mapping[str, Any]
    parent: str | None = None  # parent layer digest, None for the first layer

    def __post_init__(self):
        if self.kind not in LAYER_KINDS:
            raise ValueError(f"unknown layer kind {self.kind!r}; one of {LAYER_KINDS}")
        # freeze payload
        object.__setattr__(self, "payload", dict(self.payload))

    @property
    def digest(self) -> str:
        body = canonical_json({"kind": self.kind, "payload": self.payload, "parent": self.parent})
        return _sha256(body)

    def to_json(self) -> str:
        return canonical_json({"kind": self.kind, "payload": self.payload, "parent": self.parent})

    @staticmethod
    def from_json(text: str) -> "Layer":
        d = json.loads(text)
        return Layer(kind=d["kind"], payload=d["payload"], parent=d["parent"])


@dataclass(frozen=True)
class EnvImage:
    """An immutable chain of layers.

    ``digest`` identifies the image; because each layer hashes its parent,
    the top layer digest alone pins the whole chain, but we also hash the
    explicit list so an image object is self-verifying.
    """

    layers: tuple[Layer, ...]

    def __post_init__(self):
        if not self.layers:
            raise ValueError("an image needs at least one layer")
        if self.layers[0].parent is not None:
            raise ValueError("first layer must have parent=None")
        for prev, cur in zip(self.layers, self.layers[1:]):
            if cur.parent != prev.digest:
                raise ValueError(
                    f"broken layer chain: {cur.kind} parent {cur.parent!r} != {prev.digest!r}"
                )

    @property
    def digest(self) -> str:
        return _sha256(canonical_json([l.digest for l in self.layers]))

    @property
    def short_digest(self) -> str:
        return self.digest[:12]

    # ---- merged config ------------------------------------------------
    def config(self) -> dict[str, Any]:
        """Left-fold of layer deltas -> the complete environment description.

        Shape of the result:
          {"base": {...}, "arch": {"name":..., "overrides": {...}},
           "shape": {...}, "mesh": {...}, "precision": {...},
           "collectives": {...}, "settings": {...}, "labels": {...}}
        """
        cfg: dict[str, Any] = {
            "base": {},
            "arch": None,
            "shape": None,
            "mesh": None,
            "precision": {"params": "float32", "compute": "bfloat16", "grads": "float32"},
            "collectives": {"name": "generic"},
            "settings": {},
            "labels": {},
        }
        for layer in self.layers:
            p = dict(layer.payload)
            if layer.kind == "base":
                cfg["base"].update(p)
            elif layer.kind == "arch":
                cfg["arch"] = p
            elif layer.kind == "shape":
                cfg["shape"] = p
            elif layer.kind == "mesh":
                cfg["mesh"] = p
            elif layer.kind == "precision":
                cfg["precision"].update(p)
            elif layer.kind == "collectives":
                cfg["collectives"] = p
            elif layer.kind == "set":
                cfg["settings"].update(p)
            elif layer.kind == "label":
                cfg["labels"].update(p)
        return cfg

    def history(self) -> list[tuple[str, str, str]]:
        """(digest12, kind, payload-summary) per layer -- `docker history` analog."""
        out = []
        for l in self.layers:
            summary = canonical_json(l.payload)
            if len(summary) > 72:
                summary = summary[:69] + "..."
            out.append((l.digest[:12], l.kind, summary))
        return out


class ImageBuilder:
    """Programmatic Dockerfile: appends layers, builds an EnvImage.

    ``ImageBuilder.from_image(img)`` is the `FROM <tag>` directive -- the new
    image shares every existing layer object with its base (layer dedupe).
    """

    FORMAT_VERSION = 1

    def __init__(self, layers: Iterable[Layer] = ()):
        self._layers: list[Layer] = list(layers)

    # -- FROM ------------------------------------------------------------
    @classmethod
    def from_scratch(cls, framework_version: str | None = None) -> "ImageBuilder":
        from repro_torch import __version__

        b = cls()
        b._append(
            "base",
            {
                "format": cls.FORMAT_VERSION,
                "framework": "stevedore",
                "framework_version": framework_version or __version__,
            },
        )
        return b

    @classmethod
    def from_image(cls, image: EnvImage) -> "ImageBuilder":
        return cls(image.layers)

    # -- directives --------------------------------------------------------
    def arch(self, name: str, **overrides: Any) -> "ImageBuilder":
        return self._append("arch", {"name": name, "overrides": overrides})

    def shape(self, name: str, **overrides: Any) -> "ImageBuilder":
        return self._append("shape", {"name": name, **overrides})

    def mesh(self, platform: str, **overrides: Any) -> "ImageBuilder":
        return self._append("mesh", {"platform": platform, **overrides})

    def precision(self, **dtypes: str) -> "ImageBuilder":
        bad = set(dtypes) - {"params", "compute", "grads"}
        if bad:
            raise ValueError(f"unknown precision keys {bad}")
        return self._append("precision", dtypes)

    def collectives(self, name: str, **options: Any) -> "ImageBuilder":
        return self._append("collectives", {"name": name, **options})

    def set(self, **settings: Any) -> "ImageBuilder":
        return self._append("set", settings)

    def label(self, **labels: str) -> "ImageBuilder":
        return self._append("label", labels)

    # -- build -------------------------------------------------------------
    def build(self) -> EnvImage:
        if not self._layers:
            raise ValueError("empty build: start with from_scratch()/from_image()")
        return EnvImage(tuple(self._layers))

    def _append(self, kind: str, payload: Mapping[str, Any]) -> "ImageBuilder":
        parent = self._layers[-1].digest if self._layers else None
        self._layers.append(Layer(kind=kind, payload=payload, parent=parent))
        return self
