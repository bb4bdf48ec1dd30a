"""Container: runtime instantiation of an EnvImage on a platform (the
port of ``repro.core.container``).

A Container binds the immutable image to

  * this rank's view of the job's mesh and its device (the MESH layer
    resolved by ``dist.mesh``: ``local`` puts every rank of a
    torch.distributed job on the data axis, each on
    ``cuda:{LOCAL_RANK % cards}``; ``platform="cpu"`` must be asked for),
  * resolved sharding rules (the logical-axis table; ZeRO-1 splits the
    optimizer state's ``embed`` dims over the batch axes, FSDP the
    params' as well),
  * the arch and precision layers (param and compute dtypes) and the
    ``remat`` and ``microbatches`` settings,
  * the collective ABI named by the image and the optimizer settings,
  * train steps (``train_step_fn``) and built serve steps, the latter
    through the Runtime's CompileCache with per-dispatch-class hit/miss
    accounting,
  * a writable overlay directory (checkpoints, metrics, container.json).

``param_shardings`` / ``opt_state_shardings`` are trees of
``dist.sharding.NamedSharding`` (spec, mesh, device). A rank holds its
part of every param (``init_params`` and ``load_params`` hand it over):
whole on a mesh whose ``model`` axis is 1 (data parallel), its model-axis
shard otherwise (tensor parallelism: heads, MLP columns, vocabulary and
experts, as the JAX package's specs split them; the model then carries
the mesh's ``ModelAxis``). Under ZeRO-1 a rank keeps its part of m, v and
the master copy (split over the batch axes as well); PowerSGD's error and
Q rows are per rank. A container of a multi-process job is one
container: rank 0 names it and alone writes its overlay. ``mesh`` gives
a container of a job a mesh other than its platform's (a ``(data,
model)`` mesh of the job's ranks). ``SET fsdp=true`` (weight FSDP, the
paper's Fig. 3 host arm with ``COLLECTIVES host``) splits every leaf's
``embed`` dim over the batch axes as well: a rank holds that part of the
params and of m, v and the master copy, the model gathers each leaf where
it reads it (``dist.sharding.FSDP``), and the train step updates the
parts. ``host mode=explicit`` keeps params whole over the batch axes
under ``fsdp`` too, as the JAX package's ``shard_map`` region does (its
``P()`` in_specs gather them at entry and its out_specs return them
whole): the same values as without it. The serve steps run on the same
parts: ``init_slot_cache``/``init_paged_cache`` allocate the rank's part
of the cache (``slot_cache_shardings``/``paged_cache_shardings``), a
step takes the rank's rows of the batch (a batch the replicas do not
divide stays whole on every replica, as ``safe_spec`` keeps it) and
returns the rank's vocab slice of the logits, and greedy tokens are the
same on every rank. Not ported, and raising where asked for (ROADMAP.md
Queue 1 item 13): PowerSGD on a model axis; an MoE arch with several
batch replicas needs the
expert-parallel dispatch (a model axis dividing its experts): ROADMAP.md
Queue 3 item 14.

The dry run's entry points (the JAX package's lowering methods):
``input_specs``, ``slot_cache_specs``/``paged_cache_specs`` and their
shardings, ``lower_step`` and ``lower_unit_probe``, which trace one step
(or one unit of a stage) under ``core.trace.Counter`` on this
container's device and return its ``Lowered`` (``cost()``,
``memory()``), and ``compile_step``. ``device`` names the device outright
(only the dry run passes one: ``meta``, one rank of a job of fake ranks,
``dist.mesh.fake_job``); without it the platform's.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time
import uuid
from functools import cached_property
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config, get_shape_cell
from repro_torch.core.abi import CollectiveABI, abi_from_image_config
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.image import EnvImage
from repro_torch.core.trace import Lowered, trace
from repro_torch.dist.mesh import (NOT_PORTED, PlatformMesh, batch_axes,
                                   make_platform_mesh, resolve_device)
from repro_torch.dist.sharding import (NamedSharding, ShardingRules,
                                       def_shardings, fsdp_of, model_axis)
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.params import (materialize, params_from_jax,
                                       tree_leaves, tree_map)
from repro_torch.models.transformer import Model
from repro_torch.serve.serve_step import ServeStepBuilder, dispatch_class
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import TrainStepBuilder


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class Container:
    def __init__(self, image: EnvImage, platform: str | None = None,
                 overlay_root: str | os.PathLike | None = None,
                 compile_cache: CompileCache | None = None,
                 mesh: PlatformMesh | None = None,
                 device: torch.device | str | None = None):
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
        self.mesh = mesh or make_platform_mesh(self.platform)
        self.device: torch.device = (torch.device(device) if device is not None
                                     else resolve_device(self.platform))
        self.abi: CollectiveABI = abi_from_image_config(cfg)
        tp = self.mesh.shape.get("model", 1)
        replicas = self.mesh.axes_size(batch_axes(self.mesh))
        if self.arch.n_experts and replicas > 1 and (
                tp == 1 or self.arch.n_experts % tp
                or self.settings.get("moe_impl", "spmd") != "spmd"):
            # the JAX package drops MoE tokens by a capacity over the
            # GLOBAL batch unless the expert-parallel moe_forward_spmd
            # runs (a model axis dividing the experts): per data shard
            raise NotImplementedError(
                f"{self.arch.name} (MoE) on {replicas} batch replicas with "
                f"no model axis dividing its {self.arch.n_experts} experts "
                "(the expert-parallel dispatch, ROADMAP.md Queue 1 item "
                "13): the reference's capacity over the global batch there "
                "is not ported (ROADMAP.md Queue 3 item 14)")
        if tp > 1 and self.abi.options.get("compression") == "powersgd":
            raise NotImplementedError(
                f"PowerSGD on a model axis of {tp}: {NOT_PORTED}")

        explicit = self.abi.options.get("mode") == "explicit"
        self.fsdp = bool(self.settings.get("fsdp", False)) and not explicit
        self.rules = ShardingRules.default(
            fsdp=self.fsdp,
            seq_parallel=bool(self.settings.get("seq_parallel", False)))
        extra_rules = self.settings.get("rules")
        if extra_rules:
            self.rules = self.rules.with_(**{
                k: (tuple(v) if isinstance(v, list) else v)
                for k, v in dict(extra_rules).items()
            })
        # ZeRO-1 on the implicit path: optimizer state splits over the
        # batch axes on 'embed' dims (the explicit path keeps it whole, as
        # the JAX package's shard_map region does)
        self.zero1 = self.abi.zero1 and not explicit
        self.opt_rules = (self.rules.with_(embed=("pod", "data"))
                          if self.zero1 else self.rules)

        prec = cfg["precision"]
        self.model = Model(self.arch, tp=tp,
                           act_dtype=_torch_dtype(prec.get("compute",
                                                           "bfloat16")),
                           remat=str(self.settings.get("remat", "none")),
                           axis=model_axis(self.mesh))
        self.model.fsdp = fsdp_of(self.mesh, self.param_shardings(),
                                  self.abi.name)
        self.param_dtype = _torch_dtype(prec.get("params", "float32"))
        self.cache_dtype = _torch_dtype(prec.get("compute", "bfloat16"))
        self.opt = OptConfig(**self.settings.get("optimizer", {}))

        self.container_id = self.mesh.broadcast_object(
            f"{image.short_digest}-{uuid.uuid4().hex[:8]}")
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
        """Materialise params on this container's device from ``seed``:
        this rank's part of each (the whole leaf is drawn, so every mesh
        gets the same values, and dropped for its part before the next
        is drawn)."""
        shs = dict(zip(map(id, tree_leaves(self.param_defs)),
                       tree_leaves(self.param_shardings())))
        return materialize(self.param_defs, seed, self.param_dtype,
                           self.device,
                           keep=lambda d, t: self._part(shs[id(d)], t))

    def load_params(self, tree):
        """Given whole params -- the port's tree of tensors, or the JAX
        package's tree as numpy arrays -- this rank's part of each, cast to
        the image's param dtype and placed on this container's device.
        Shapes are checked leaf by leaf."""
        def leaf(d, a):
            t = (a if isinstance(a, torch.Tensor)
                 else params_from_jax(a))
            if tuple(t.shape) != tuple(d.shape):
                raise ValueError(f"param shape {tuple(t.shape)} != "
                                 f"expected {tuple(d.shape)}")
            return t.to(device=self.device, dtype=self.param_dtype)
        return tree_map(self._part, self.param_shardings(),
                        tree_map(leaf, self.param_defs, tree))

    @staticmethod
    def _part(sh: NamedSharding, p: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole leaf over every mesh axis that
        splits it (its model-axis shard, its FSDP part of that): a copy, so
        the whole can go; the leaf itself where nothing splits it."""
        return sh.local(p).clone() if sh.split() else p

    def param_shardings(self):
        return def_shardings(self.param_defs, self.mesh, self.rules,
                             self.device)

    def opt_state_shardings(self):
        ps = def_shardings(self.param_defs, self.mesh, self.opt_rules,
                           self.device)
        out = {"m": ps, "v": ps,
               "step": NamedSharding(self.mesh, (), self.device)}
        if self.param_dtype != torch.float32:
            out["master"] = ps
        if self._powersgd_rank():
            baxes = batch_axes(self.mesh)
            sh0 = NamedSharding(self.mesh,
                                (baxes if len(baxes) > 1 else baxes[0],),
                                self.device)
            out["comm"] = tree_map(lambda a: None if a is None else sh0,
                                   self._comm_template())
        return out

    def abstract_params(self):
        """Meta tensors of the params' shapes and dtype (no allocation):
        the template a checkpoint restores into."""
        return tree_map(lambda d: _meta(d.shape, self.param_dtype),
                        self.param_defs)

    # -- optimizer state ------------------------------------------------------
    def abstract_opt_state(self):
        f32 = tree_map(lambda d: _meta(d.shape, torch.float32),
                       self.param_defs)
        out = {"m": f32, "v": f32, "step": _meta((), torch.int32)}
        if self.param_dtype != torch.float32:
            out["master"] = f32
        if self._powersgd_rank():
            out["comm"] = self._comm_template()
        return out

    def init_opt_state(self, params):
        """Optimizer state for ``params`` (this rank's parts): this rank's
        part of each leaf under ZeRO-1 or FSDP, the whole leaf otherwise."""
        baxes = batch_axes(self.mesh)
        parts = tree_map(lambda sh, psh, p: p if psh.split(baxes)
                         else sh.local(p, baxes),
                         self.opt_state_shardings()["m"],
                         self.param_shardings(), params)
        state = adamw_init(parts,
                           with_master=self.param_dtype != torch.float32)
        if self._powersgd_rank():
            from repro_torch.train.compression import powersgd_init
            comm = powersgd_init(params, self._powersgd_rank())
            # this rank's row of the (replicas, ...) leaves: the error
            # buffer is per-replica state, unlike params
            expand = lambda a: None if a is None else a[None].clone()
            state["comm"] = {"q": tree_map(expand, comm["q"]),
                             "err": tree_map(expand, comm["err"])}
        return state

    def _powersgd_rank(self) -> int:
        if self.abi.options.get("compression") == "powersgd":
            return int(self.abi.options.get("rank", 16))
        return 0

    def _comm_template(self):
        """Abstract comm-state tree: a per-replica leading axis on q/err
        (one row a rank), ``None`` where a leaf syncs uncompressed."""
        from repro_torch.train.compression import _compressible
        rank = self._powersgd_rank()
        nsh = self.mesh.axes_size(batch_axes(self.mesh))

        def q_leaf(d):
            if not _compressible(d, rank):
                return None
            return _meta((nsh, math.prod(d.shape[1:]), rank), torch.float32)

        def e_leaf(d):
            if not _compressible(d, rank):
                return None
            return _meta((nsh, *d.shape), torch.float32)

        return {"q": tree_map(q_leaf, self.param_defs),
                "err": tree_map(e_leaf, self.param_defs)}

    # -- train steps ----------------------------------------------------------
    def train_step_fn(self, donate: bool = False) -> Callable:
        """``step(params, opt_state, batch) -> (params, opt_state,
        metrics)`` on this container's device; ``donate`` updates params
        and optimizer state in place (``donate_argnums=(0, 1)``)."""
        builder = TrainStepBuilder(
            model=self.model, abi=self.abi, opt=self.opt,
            microbatches=int(self.settings.get("microbatches", 1)),
            donate=donate, mesh=self.mesh,
            opt_shardings=(self.opt_state_shardings()["m"]
                           if self.zero1 or self.fsdp else None))
        return builder.build()

    # -- whole-batch serve steps ------------------------------------------------
    def prefill_fn(self, cache_len: int | None = None) -> Callable:
        """``prefill(params, tokens[, frontend_embeds]) -> (last logits,
        cache)`` into ``cache_len`` positions (the cell's ``seq_len`` when
        None), under no_grad."""
        b = ServeStepBuilder(self.model)
        return torch.no_grad()(b.build_prefill(
            cache_len or (self.cell.seq_len if self.cell else 0)))

    def decode_fn(self) -> Callable:
        """``decode(params, cache, tokens (B,1), idx) -> (logits (B, Vp),
        cache)`` at a scalar or (B,) position, under no_grad."""
        return torch.no_grad()(ServeStepBuilder(self.model).build_decode())

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
        """This rank's part of each cache def, zeroed, on this device."""
        return tree_map(lambda d, sh: torch.zeros(
            sh.local_shape(d.shape), dtype=self.cache_leaf_dtype(d),
            device=self.device), defs,
            def_shardings(defs, self.mesh, self.rules))

    def init_slot_cache(self, n_slots: int, max_len: int):
        """Zero-initialised contiguous slot cache on this device: this
        rank's part (``slot_cache_shardings``)."""
        return self._zeros(self.model.cache_defs(n_slots, max_len))

    def init_paged_cache(self, n_pages: int, page_size: int):
        """Zero-initialised page pool: per attention layer (n_kv, n_pages,
        page_size, hd), this rank's part (``paged_cache_shardings``);
        slots address it through the host PagePool's table."""
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
        so the keys stay those of the JAX package). ``prefill`` is the
        whole-batch prefill into ``cache_len`` positions. ``generate`` is
        the greedy loop of ``gen_steps`` steps over a (batch, cache_len)
        cache; with ``per_row`` it takes a (batch,) vector of start
        positions, as for mixed-length waves, else one scalar start. Runs
        under no_grad."""
        b = ServeStepBuilder(self.model)
        if kind == "prefill":
            fn = b.build_prefill(cache_len)
        elif kind == "prefill_slot":
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

    # -- input specs (meta stand-ins; no allocation) --------------------------
    def _local_meta(self, defs, shardings, dtype_of) -> dict:
        """Meta tensors of this rank's part of each def."""
        return tree_map(lambda d, sh: _meta(sh.local_shape(d.shape),
                                            dtype_of(d)), defs, shardings)

    def _replicas(self) -> int:
        return self.mesh.axes_size(batch_axes(self.mesh))

    def _rows(self, batch: int) -> int:
        """This rank's rows of a ``batch``: its share where the replicas
        divide it, else the whole batch (``safe_spec`` keeps it
        replicated, as the reference's ``_safe_spec`` does)."""
        reps = self._replicas()
        return batch // reps if batch % reps == 0 else batch

    def input_specs(self, kind: str | None = None) -> dict:
        """Meta tensors of this rank's inputs to a ``kind`` step at the
        cell's shapes (the JAX package's keys): its rows of the batch
        (tokens and labels as int64, what the step reads), the cache of its
        rows, a (B, 1) token column and a 0-d int32 position. A batch the
        replicas do not divide is whole on every replica (``_rows``); a
        train step's still raises."""
        cell = self.cell
        if cell is None:
            raise ValueError("image has no SHAPE layer")
        kind = kind or cell.kind
        B, S = cell.global_batch, cell.seq_len
        reps = self._replicas()
        if kind == "train" and B % reps:
            raise ValueError(f"a global batch of {B} rows does not split "
                             f"over {reps} replicas")
        B = self._rows(B)
        fe_len = self.arch.frontend_len if self.arch.frontend else 0
        tok = _meta((B, S - fe_len), torch.int64)
        fe = (_meta((B, fe_len, self.arch.d_model), self.cache_dtype)
              if fe_len else None)
        if kind == "train":
            batch = {"tokens": tok, "labels": _meta((B, S - fe_len),
                                                    torch.int64)}
            if fe is not None:
                batch["frontend_embeds"] = fe
            return {"batch": batch}
        if kind == "prefill":
            out = {"tokens": tok}
            if fe is not None:
                out["frontend_embeds"] = fe
            return out
        if kind == "decode":
            defs = self.model.cache_defs(cell.global_batch, S)
            return {"cache": self._local_meta(
                        defs, def_shardings(defs, self.mesh, self.rules),
                        self.cache_leaf_dtype),
                    "tokens": _meta((B, 1), torch.int64),
                    "idx": _meta((), torch.int32)}
        raise ValueError(f"unknown step kind {kind!r}")

    def slot_cache_specs(self, n_slots: int, max_len: int):
        """Meta tensors of a slot cache (``init_slot_cache``'s shapes and
        dtypes, whole)."""
        return tree_map(lambda d: _meta(d.shape, self.cache_leaf_dtype(d)),
                        self.model.cache_defs(n_slots, max_len))

    def slot_cache_shardings(self, n_slots: int, max_len: int):
        return def_shardings(self.model.cache_defs(n_slots, max_len),
                             self.mesh, self.rules, self.device)

    def paged_cache_specs(self, n_pages: int, page_size: int):
        """Meta tensors of a page pool (``init_paged_cache``'s, whole)."""
        return tree_map(lambda d: _meta(d.shape, self.cache_leaf_dtype(d)),
                        self.model.paged_cache_defs(n_pages, page_size))

    def paged_cache_shardings(self, n_pages: int, page_size: int):
        return def_shardings(self.model.paged_cache_defs(n_pages, page_size),
                             self.mesh, self.rules, self.device)

    # -- lowering (the dry run's entry) ------------------------------------------
    def _rank_params(self):
        """This rank's parts of the params, uninitialised, on this
        container's device (``meta`` in the dry run)."""
        return tree_map(lambda d, sh: torch.empty(
            sh.local_shape(d.shape), dtype=self.param_dtype,
            device=self.device), self.param_defs, self.param_shardings())

    def _on_device(self, tree):
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=self.device), tree)

    def lower_step(self, kind: str | None = None,
                   donate: bool = True) -> Lowered:
        """Trace one ``kind`` step of this image's cell on this container's
        device (``core.trace.trace``): this rank's params and
        optimizer state, uninitialised, and its inputs (``input_specs``).
        A train step takes the global batch and keeps its rows (a view),
        so its arguments count this rank's rows only; ``donate`` updates
        params and optimizer state in place."""
        kind = kind or (self.cell.kind if self.cell else "train")
        specs = self._on_device(self.input_specs(kind))
        params = self._rank_params()
        if kind == "train":
            opt_state = self.init_opt_state(params)
            args_bytes = sum(t.nbytes for t in tree_leaves(
                {"p": params, "o": opt_state, "b": specs["batch"]})
                if t is not None)
            reps = self._replicas()
            batch = {k: v.new_empty((v.shape[0] * reps, *v.shape[1:]))
                     for k, v in specs["batch"].items()}
            step = self.train_step_fn(donate=donate)
            return trace(step, (params, opt_state, batch), self.mesh,
                         args_bytes)[0]
        if kind == "prefill":
            args = (params, specs["tokens"])
            if "frontend_embeds" in specs:
                args += (specs["frontend_embeds"],)
            return trace(self.prefill_fn(), args, self.mesh)[0]
        if kind == "decode":
            return trace(self.decode_fn(), (params, specs["cache"],
                                            specs["tokens"], specs["idx"]),
                         self.mesh)[0]
        raise ValueError(f"unknown step kind {kind!r}")

    def lower_unit_probe(self, si: int,
                         kind: str | None = None) -> tuple[Lowered, int]:
        """Trace one unit of stage ``si`` (``Model.unit_probe``) on this
        rank's parts and rows -> (its ``Lowered``, the stage's unit
        count)."""
        kind = kind or (self.cell.kind if self.cell else "train")
        st = self.model.stages[si]
        cell = self.cell
        B = self._rows(cell.global_batch)
        S = cell.seq_len if kind != "decode" else 1
        udefs = self.model.unit_param_defs(si)
        up = tree_map(lambda d, sh: torch.empty(
            sh.local_shape(d.shape), dtype=self.param_dtype,
            device=self.device), udefs,
            def_shardings(udefs, self.mesh, self.rules))
        x = torch.empty((B, S, self.arch.d_model), dtype=self.model.act_dtype,
                        device=self.device)
        probe = self.model.unit_probe(si, kind)
        if kind in ("train", "prefill"):
            pos = torch.empty((1, S), dtype=torch.int32, device=self.device)
            return trace(probe, (up, x, pos), self.mesh)[0], st.count
        if kind == "decode":
            cdefs = self.model.unit_cache_defs(si, cell.global_batch,
                                               cell.seq_len)
            cache = self._on_device(self._local_meta(
                cdefs, def_shardings(cdefs, self.mesh, self.rules),
                self.cache_leaf_dtype))
            idx = torch.empty((), dtype=torch.int32, device=self.device)
            return trace(probe, (up, cache, x, idx), self.mesh)[0], st.count
        raise ValueError(f"unknown step kind {kind!r}")

    def compile_step(self, kind: str | None = None) -> Callable:
        """The built ``kind`` step (``train_step_fn``, ``prefill_fn`` or
        ``decode_fn``), through the CompileCache when one is attached:
        the built callable is the port's one level (an eager step has no
        executable to keep)."""
        kind = kind or (self.cell.kind if self.cell else "train")
        builders = {"train": self.train_step_fn, "prefill": self.prefill_fn,
                    "decode": self.decode_fn}
        if kind not in builders:
            raise ValueError(f"unknown step kind {kind!r}")
        if self.compile_cache is None:
            return builders[kind]()
        key = self.compile_cache.key(image_digest=self.image.digest,
                                     step_kind=kind, device=self.device)
        return self.compile_cache.get_or_build(key, builders[kind])

    # -- overlay (writable layer) ----------------------------------------------
    def ensure_overlay(self) -> Path:
        """The overlay directory, made and described by rank 0 (another
        rank's returns its path)."""
        if self.mesh.rank:
            return self.overlay
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
        """Append a step's metrics to ``metrics.jsonl`` (rank 0 only)."""
        if self.mesh.rank:
            return
        self.ensure_overlay()
        rec = {"step": step}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") or isinstance(
                v, (int, float, np.floating)) else v
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
