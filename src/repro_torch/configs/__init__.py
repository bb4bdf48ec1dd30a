"""Architecture config registry: one module per assigned architecture."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, ShapeCell, SHAPE_CELLS, get_shape_cell

ARCH_IDS = (
    "recurrentgemma-2b",
    "deepseek-67b",
    "nemotron-4-15b",
    "llama3.2-3b",
    "stablelm-3b",
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "mamba2-2.7b",
    "musicgen-medium",
    "internvl2-2b",
)

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch.endswith("-smoke"):
        return get_config(arch[: -len("-smoke")], **overrides).reduced()
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.with_overrides(**overrides) if overrides else cfg


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS


__all__ = ["ARCH_IDS", "get_config", "list_archs", "ModelConfig", "ShapeCell",
           "SHAPE_CELLS", "get_shape_cell"]
