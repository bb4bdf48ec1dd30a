"""Imagefile: the Dockerfile analog (paper §2.2).

A plain-text, line-oriented, deterministic description of an EnvImage build::

    FROM scratch                      # or FROM <tag-or-digest> (needs a registry)
    ARCH llama3.2-3b n_layers=28
    SHAPE train_4k
    MESH pod
    PRECISION compute=bfloat16 params=float32
    COLLECTIVES host zero1=true grad_compression=bfloat16
    SET remat=selective scan_layers=true
    LABEL maintainer=stevedore tier=stable

Values parse as JSON scalars when possible (true/false/ints/floats), else as
strings -- so ``zero1=true`` is a bool and ``window=2048`` an int, mirroring
how a Dockerfile's build args stay uninterpreted until used.
"""

from __future__ import annotations

import json
from typing import Any

from repro_torch.core.image import EnvImage, ImageBuilder

DIRECTIVES = ("FROM", "ARCH", "SHAPE", "MESH", "PRECISION", "COLLECTIVES", "SET", "LABEL")


class ImagefileError(ValueError):
    pass


def _parse_value(raw: str) -> Any:
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return raw


def _parse_kv(tokens: list[str], directive: str, lineno: int) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for tok in tokens:
        if "=" not in tok:
            raise ImagefileError(f"line {lineno}: {directive} expects key=value, got {tok!r}")
        k, _, v = tok.partition("=")
        out[k] = _parse_value(v)
    return out


def parse_imagefile(text: str, registry=None) -> EnvImage:
    """Build an EnvImage from Imagefile text.

    ``FROM <ref>`` other than ``scratch`` resolves through ``registry``
    (a repro_torch.core.registry.Registry), inheriting all base layers -- the
    paper's `FROM quay.io/fenicsproject/stable` pattern.
    """
    builder: ImageBuilder | None = None
    for lineno, raw_line in enumerate(text.splitlines(), start=1):
        line = raw_line.split("#", 1)[0].strip()
        if not line:
            continue
        tokens = line.split()
        directive, args = tokens[0].upper(), tokens[1:]
        if directive not in DIRECTIVES:
            raise ImagefileError(f"line {lineno}: unknown directive {directive!r}")

        if directive == "FROM":
            if builder is not None:
                raise ImagefileError(f"line {lineno}: FROM must be the first directive")
            if len(args) != 1:
                raise ImagefileError(f"line {lineno}: FROM takes exactly one ref")
            ref = args[0]
            if ref == "scratch":
                builder = ImageBuilder.from_scratch()
            else:
                if registry is None:
                    raise ImagefileError(
                        f"line {lineno}: FROM {ref!r} needs a registry to resolve against"
                    )
                builder = ImageBuilder.from_image(registry.pull(ref))
            continue

        if builder is None:
            raise ImagefileError(f"line {lineno}: first directive must be FROM")

        if directive in ("ARCH", "SHAPE", "MESH", "COLLECTIVES"):
            if not args:
                raise ImagefileError(f"line {lineno}: {directive} needs a name")
            name, kv = args[0], _parse_kv(args[1:], directive, lineno)
            if directive == "ARCH":
                builder.arch(name, **kv)
            elif directive == "SHAPE":
                builder.shape(name, **kv)
            elif directive == "MESH":
                builder.mesh(name, **kv)
            else:
                builder.collectives(name, **kv)
        elif directive == "PRECISION":
            builder.precision(**_parse_kv(args, directive, lineno))
        elif directive == "SET":
            builder.set(**_parse_kv(args, directive, lineno))
        elif directive == "LABEL":
            builder.label(**{k: str(v) for k, v in _parse_kv(args, directive, lineno).items()})

    if builder is None:
        raise ImagefileError("empty Imagefile")
    return builder.build()


def render_imagefile(image: EnvImage) -> str:
    """Inverse of parse: emit Imagefile text for an image (``docker history``
    in reusable form). parse(render(img)) reproduces img's digest when the
    image was built from scratch."""
    lines: list[str] = []
    for layer in image.layers:
        p = dict(layer.payload)
        if layer.kind == "base":
            lines.append("FROM scratch")
        elif layer.kind == "arch":
            kv = " ".join(f"{k}={json.dumps(v)}" for k, v in sorted(p.get("overrides", {}).items()))
            lines.append(f"ARCH {p['name']}" + (f" {kv}" if kv else ""))
        elif layer.kind in ("shape", "mesh", "collectives"):
            key = {"shape": "SHAPE", "mesh": "MESH", "collectives": "COLLECTIVES"}[layer.kind]
            name = p.pop("name", None) or p.pop("platform", None)
            kv = " ".join(f"{k}={json.dumps(v)}" for k, v in sorted(p.items()))
            lines.append(f"{key} {name}" + (f" {kv}" if kv else ""))
        elif layer.kind == "precision":
            kv = " ".join(f"{k}={v}" for k, v in sorted(p.items()))
            lines.append(f"PRECISION {kv}")
        elif layer.kind == "set":
            kv = " ".join(f"{k}={json.dumps(v)}" for k, v in sorted(p.items()))
            lines.append(f"SET {kv}")
        elif layer.kind == "label":
            kv = " ".join(f"{k}={v}" for k, v in sorted(p.items()))
            lines.append(f"LABEL {kv}")
    return "\n".join(lines) + "\n"
