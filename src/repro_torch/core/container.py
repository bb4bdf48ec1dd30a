"""Container: runtime instantiation of an EnvImage on a platform (the
serving half of ``repro.core.container``).

A Container binds the immutable image to

  * a concrete device (the MESH layer resolved by ``dist.mesh``: ``local``
    is ``cuda:0``; ``platform="cpu"`` must be asked for),
  * the arch and precision layers (param and compute dtypes),
  * built serve steps, obtained through the Runtime's CompileCache with
    per-dispatch-class hit/miss accounting,
  * a writable overlay directory (metrics, container.json).

Training (optimizer state, train steps, the collective ABI) comes with the
training slice of the port (ROADMAP.md Queue 1 item 11); those methods
raise ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import uuid
from functools import cached_property
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config, get_shape_cell
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.image import EnvImage
from repro_torch.dist.mesh import resolve_device
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.params import (materialize, params_from_jax,
                                       tree_map)
from repro_torch.models.transformer import Model
from repro_torch.serve.serve_step import ServeStepBuilder, dispatch_class

_TRAINING = ("training is not ported yet (ROADMAP.md Queue 1 item 11: "
             "training and distribution)")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class Container:
    def __init__(self, image: EnvImage, platform: str | None = None,
                 overlay_root: str | os.PathLike | None = None,
                 compile_cache: CompileCache | None = None):
        self.image = image
        cfg = image.config()
        if cfg["arch"] is None:
            raise ValueError("image has no ARCH layer")
        self.settings: dict = dict(cfg.get("settings", {}))
        self.arch: ModelConfig = get_config(
            cfg["arch"]["name"], **cfg["arch"].get("overrides", {}))
        shape_cfg = dict(cfg.get("shape") or {})
        self.cell: ShapeCell | None = None
        if shape_cfg:
            base = get_shape_cell(shape_cfg.pop("name"))
            self.cell = base.scaled(**shape_cfg) if shape_cfg else base

        # platform: image default, overridable at run time (docker-run style)
        mesh_cfg = dict(cfg.get("mesh") or {"platform": "local"})
        self.platform = platform or mesh_cfg.get("platform", "local")
        self.device: torch.device = resolve_device(self.platform)

        prec = cfg["precision"]
        self.model = Model(self.arch, tp=1,
                           act_dtype=_torch_dtype(prec.get("compute",
                                                           "bfloat16")))
        self.param_dtype = _torch_dtype(prec.get("params", "float32"))
        self.cache_dtype = _torch_dtype(prec.get("compute", "bfloat16"))

        self.container_id = f"{image.short_digest}-{uuid.uuid4().hex[:8]}"
        self.overlay = (Path(overlay_root) if overlay_root
                        else Path(".stevedore") / "overlays") / self.container_id
        self.compile_cache = compile_cache
        self._metrics_path = self.overlay / "metrics.jsonl"
        # serve-step build accounting, bucketed by dispatch class
        # ("prefill"/"decode"/"other" -> {hits, misses, seconds})
        self.serve_compile_stats: dict[str, dict] = {}

    # -- parameters ---------------------------------------------------------
    @cached_property
    def param_defs(self):
        return self.model.param_defs()

    def init_params(self, seed: int = 0):
        """Materialise params on this container's device from ``seed``."""
        return materialize(self.param_defs, seed, self.param_dtype,
                           self.device)

    def load_params(self, tree):
        """Given params -- the port's tree of tensors, or the JAX package's
        tree as numpy arrays -- cast to the image's param dtype and placed
        on this container's device. Shapes are checked leaf by leaf."""
        def leaf(d, a):
            t = (a if isinstance(a, torch.Tensor)
                 else params_from_jax(a))
            if tuple(t.shape) != tuple(d.shape):
                raise ValueError(f"param shape {tuple(t.shape)} != "
                                 f"expected {tuple(d.shape)}")
            return t.to(device=self.device, dtype=self.param_dtype)
        return tree_map(leaf, self.param_defs, tree)

    def train_step_fn(self) -> Callable:
        raise NotImplementedError(_TRAINING)

    def init_opt_state(self, params):
        raise NotImplementedError(_TRAINING)

    # -- serving: slot-granular cache + built serve steps ----------------------
    def cache_leaf_dtype(self, d) -> torch.dtype:
        """The dtype of one (layer-stacked) cache leaf, by the JAX package's
        ``_abstract_cache`` rule: recurrent states stay float32 -- a 3-dim
        leaf whose last axis is ``rnn`` (the RG-LRU state) or a 5-dim leaf
        with ``heads`` at axis 2 (the SSM state); KV slabs and conv tails
        take the compute dtype."""
        if d.shape and d.logical and (
                d.logical[-1] == "rnn" and len(d.shape) == 3
                or (len(d.shape) == 5 and d.logical[2] == "heads")):
            return torch.float32
        return self.cache_dtype

    def _zeros(self, defs):
        return tree_map(lambda d: torch.zeros(
            d.shape, dtype=self.cache_leaf_dtype(d), device=self.device), defs)

    def init_slot_cache(self, n_slots: int, max_len: int):
        """Zero-initialised contiguous slot cache on this device."""
        return self._zeros(self.model.cache_defs(n_slots, max_len))

    def init_paged_cache(self, n_pages: int, page_size: int):
        """Zero-initialised page pool: per attention layer (n_kv, n_pages,
        page_size, hd); slots address it through the host PagePool's
        table."""
        return self._zeros(self.model.paged_cache_defs(n_pages, page_size))

    def build_serve_step(self, kind: str, *, batch: int | None = None,
                         prompt_len: int | None = None,
                         cache_len: int | None = None,
                         gen_steps: int | None = None,
                         n_pages: int | None = None,
                         page_size: int | None = None,
                         max_pages: int | None = None,
                         frontend_len: int | None = None,
                         prefix_len: int | None = None,
                         per_row: bool | None = None) -> Callable:
        """A serving step at the given shapes (the ``lower_serve_step``
        counterpart; the shapes the eager step does not need are accepted
        so the keys stay those of the JAX package). ``generate`` is the
        greedy loop of ``gen_steps`` steps over a (batch, cache_len) cache;
        with ``per_row`` it takes a (batch,) vector of start positions, as
        for mixed-length waves, else one scalar start. Runs under
        no_grad."""
        b = ServeStepBuilder(self.model)
        if kind == "prefill_slot":
            fn = b.build_prefill_slot(cache_len, frontend_len or 0)
        elif kind == "decode_slots":
            fn = b.build_decode_slots()
        elif kind == "decode_chunk":
            fn = b.build_decode_chunk(gen_steps)
        elif kind == "prefill_slot_paged":
            fn = b.build_prefill_slot_paged(prompt_len, page_size,
                                            frontend_len or 0,
                                            prefix_len or 0)
        elif kind == "decode_slots_paged":
            fn = b.build_decode_slots_paged()
        elif kind == "decode_chunk_paged":
            fn = b.build_decode_chunk_paged(gen_steps)
        elif kind == "generate":
            fn = b.build_generate_loop(gen_steps, bool(per_row))
        else:
            raise ValueError(f"unknown serve step kind {kind!r}")
        return torch.no_grad()(fn)

    def _serve_cache_digest(self) -> str:
        """Cache identity for serve steps: only the image config sections
        that determine the computation (arch/mesh/precision/settings), so a
        release that only re-points a tag at an image with new LABEL or
        COLLECTIVES layers reuses the built steps."""
        cfg = self.image.config()
        rel = {k: cfg.get(k) for k in ("arch", "mesh", "precision",
                                       "settings")}
        return hashlib.sha256(
            json.dumps(rel, sort_keys=True, default=str).encode()).hexdigest()

    def compile_serve_step(self, kind: str, **shapes):
        """Build a serve step through the CompileCache when attached, with
        hit/miss/seconds accounting per dispatch class."""
        acct = self.serve_compile_stats.setdefault(
            dispatch_class(kind), {"hits": 0, "misses": 0, "seconds": 0.0})
        if self.compile_cache is None:
            t0 = time.perf_counter()
            fn = self.build_serve_step(kind, **shapes)
            acct["misses"] += 1
            acct["seconds"] += time.perf_counter() - t0
            return fn
        sig = ",".join(f"{k}={v}" for k, v in sorted(shapes.items())
                       if v is not None)
        key = self.compile_cache.key(
            image_digest=self._serve_cache_digest(),
            step_kind=f"serve:{kind}[{sig}]", device=self.device)
        stats = self.compile_cache.stats
        hits0, miss0 = stats.hits_l1 + stats.hits_l2, stats.misses
        fn = self.compile_cache.get_or_build(
            key, lambda: self.build_serve_step(kind, **shapes))
        acct["hits"] += (stats.hits_l1 + stats.hits_l2) - hits0
        acct["misses"] += stats.misses - miss0
        acct["seconds"] += stats.last_seconds
        return fn

    # -- overlay (writable layer) ----------------------------------------------
    def ensure_overlay(self) -> Path:
        self.overlay.mkdir(parents=True, exist_ok=True)
        meta = self.overlay / "container.json"
        if not meta.exists():
            meta.write_text(json.dumps({
                "image": self.image.digest,
                "platform": self.platform,
                "device": str(self.device),
                "arch": self.arch.name,
                "cell": self.cell.name if self.cell else None,
            }, indent=2))
        return self.overlay

    def log_metrics(self, step: int, metrics: dict) -> None:
        self.ensure_overlay()
        rec = {"step": step}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") or isinstance(
                v, (int, float, np.floating)) else v
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
