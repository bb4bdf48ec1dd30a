"""Logical-axis sharding rules: model-code axis names -> mesh specs (the
port of ``repro.dist.sharding``; the rules, ``mesh_axes``, ``safe_spec``
and ``check_divisibility`` are the JAX package's logic, copied).

Model modules annotate tensors with *logical* axis names ("batch",
"embed", "mlp", ...). A ``ShardingRules`` table maps each name to zero or
more mesh axes; ``mesh_axes`` / ``safe_spec`` translate a logical tuple
into a spec with two safety guarantees:

  * an axis absent from the mesh is silently dropped (the same rules drive
    the 2-axis local mesh and the 3-axis multipod mesh);
  * one mesh axis never shards two dims of the same tensor (first logical
    dim to claim it wins);

and, for ``safe_spec`` (which also sees the shape):

  * a dim is never sharded by more mesh axes than divide it evenly
    (a greedy prefix of the rule's axes is kept, preserving collective
    layout order).

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of axis names (what ``jax.sharding.PartitionSpec`` holds). A
``NamedSharding`` pairs a spec with a ``PlatformMesh``: each rank holds
the part of a tensor at its coordinates along the spec's axes, on every
dim the spec splits (a ZeRO-1 moment of ``wq`` on a (data, model) mesh:
``(("data",), "model", None)``, its embed dim over data and its heads
over model).

Tensor parallelism. Where the JAX package lets GSPMD insert the
collectives a ``with_sharding_constraint`` implies (``constrain``), the
port's model code places them itself, on the ``model`` axis
(``ModelAxis``): ``copy_to_model`` at the entry of a region that a rank
computes on its own part of the weights (the identity forward, an
all-reduce of the gradient over ``model`` backward) and
``reduce_from_model`` at its exit (an all-reduce of the rank's partial
sum forward, the identity backward). What a region reads enters through
``copy_to_model``; a replicated weight is never read inside one, so no
parameter ends a backward with a partial gradient. Their bytes count in
the mesh's ``CollectiveStats`` under ``TP``. With ``model`` at 1 there is
no ``ModelAxis`` and both are the identity: no operator, no collective.
Two more model-axis operators serve the Mamba-2 block (``models/ssm.py``):
``sum_over_model`` (an all-reduce both ways: a sum every rank's result
depends on, as ``rms_gated``'s sum of squares over the whole ``d_inner``)
and ``gather_from_model`` (an all-gather of a row-split leaf forward, the
reduce-scatter of the ranks' gradients backward), with ``once_over_model``
for the rows of such a leaf that every rank uses in replicated math.

Weight FSDP (``ShardingRules.default(fsdp=True)``: ``embed`` dims over the
batch axes): a rank holds its part of every leaf the rule splits, and the
model gathers the whole leaf -- over the batch axes only, so on a ``model``
axis the rank's model-axis shard -- where it reads it (``FSDP.gather``):
an all-gather forward, the reduce-scatter of the gradient's replica mean
backward, counted in ``CollectiveStats`` under the ABI's name. The
gradient of such a leaf leaves the backward as this rank's part, already
meaned over the replicas.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from repro_torch.dist.mesh import (PlatformMesh, batch_axes, batch_index,
                                   collective)

Rule = str | tuple[str, ...] | None
Spec = tuple
TP = "tp"           # the model axis's label in CollectiveStats

# The canonical table. Batch-like dims shard over the replica axes
# ("pod","data", slow-to-fast -- see dist.mesh.batch_axes); tensor-parallel
# dims over "model". "embed" stays replicated unless FSDP turns it on.
_DEFAULT_RULES: dict[str, Rule] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "capacity": ("pod", "data"),
    "rnn": "model",
    "layers": None,
}


@dataclass(frozen=True)
class ShardingRules:
    """Immutable logical-axis -> mesh-axis table."""

    rules: Mapping[str, Rule]

    @classmethod
    def default(cls, fsdp: bool = False,
                seq_parallel: bool = False) -> "ShardingRules":
        r = dict(_DEFAULT_RULES)
        if fsdp:
            # param "embed" dims shard over the replica axes (weight FSDP;
            # ZeRO-1 applies the same rule to optimizer state only).
            r["embed"] = ("pod", "data")
        if seq_parallel:
            # activations' sequence dim shards over the model axis
            r["seq"] = "model"
        return cls(r)

    def with_(self, **updates: Rule) -> "ShardingRules":
        r = dict(self.rules)
        for k, v in updates.items():
            r[k] = tuple(v) if isinstance(v, list) else v
        return ShardingRules(r)

    def mesh_axes(self, logical: Sequence[str | None], mesh,
                  exclude_axes: Sequence[str] = ()) -> Spec:
        """Translate logical axis names into a spec for ``mesh``.

        Mesh axes already claimed (or listed in ``exclude_axes``) are
        never reused.
        """
        used: set[str] = set(exclude_axes)
        entries: list[Rule] = []
        for name in logical:
            rule = self.rules.get(name) if name is not None else None
            if rule is None:
                entries.append(None)
            elif isinstance(rule, str):
                if rule in mesh.axis_names and rule not in used:
                    used.add(rule)
                    entries.append(rule)
                else:
                    entries.append(None)
            else:
                ax = tuple(a for a in rule
                           if a in mesh.axis_names and a not in used)
                used.update(ax)
                entries.append(ax if ax else None)
        return tuple(entries)


def _axes_of(entry: Rule) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def safe_spec(shape: Sequence[int], logical: Sequence[str | None], mesh,
              rules: ShardingRules, exclude_axes: Sequence[str] = ()) -> Spec:
    """A spec for ``shape`` that is guaranteed divisible.

    Per dim, a greedy prefix of the rule's mesh axes is kept while the
    cumulative axis product divides the dim; order is preserved so the
    collective layout never flips between callers.
    """
    spec = rules.mesh_axes(logical, mesh, exclude_axes=exclude_axes)
    entries: list[Rule] = []
    for dim, entry in zip(shape, spec):
        axes = _axes_of(entry)
        kept: list[str] = []
        prod = 1
        for a in axes:
            if dim % (prod * mesh.shape[a]) == 0:
                kept.append(a)
                prod *= mesh.shape[a]
            else:
                break
        if not kept:
            entries.append(None)
        elif isinstance(entry, str):
            entries.append(kept[0])
        else:
            entries.append(tuple(kept))
    return tuple(entries)


def check_divisibility(shape: Sequence[int], spec: Spec, mesh) -> None:
    """Raise if ``spec`` shards any dim of ``shape`` non-evenly."""
    for i, (dim, entry) in enumerate(zip(shape, spec)):
        k = 1
        for a in _axes_of(entry):
            k *= mesh.shape[a]
        if dim % k:
            raise ValueError(
                f"dim {i} of shape {tuple(shape)} not divisible by mesh axes "
                f"{entry!r} (product {k})")


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``), plus the device
    this rank's part lives on."""

    mesh: PlatformMesh
    spec: Spec
    device: torch.device | str | None = None

    def split_axes(self, axes=None) -> list[tuple[int, tuple[str, ...]]]:
        """(dim, the mesh axes above size 1 that split it) for each dim the
        spec splits, counting only the mesh axes in ``axes`` when given."""
        out = []
        for i, e in enumerate(self.spec):
            ax = tuple(a for a in _axes_of(e) if self.mesh.shape[a] > 1
                       and (axes is None or a in axes))
            if ax:
                out.append((i, ax))
        return out

    def _part(self, rank: int, axes: tuple[str, ...]) -> int:
        """``rank``'s coordinates along ``axes``, read row-major."""
        c, idx = self.mesh.coords(rank), 0
        for a in axes:
            idx = idx * self.mesh.shape[a] + c[a]
        return idx

    def split(self, axes=None) -> tuple[tuple[int, int, list[int]], ...]:
        """(dim, parts, part of each rank) for each dim the spec splits
        over mesh axes of size above 1 (only over those in ``axes`` when
        given), in dim order; rank r holds part ``owners[r]`` of the dim,
        its coordinates along the dim's axes read row-major. Empty when
        the spec splits nothing."""
        return tuple((dim, self.mesh.axes_size(ax),
                      [self._part(r, ax) for r in range(self.mesh.size)])
                     for dim, ax in self.split_axes(axes))

    def local(self, full: torch.Tensor, axes=None,
              rank: int | None = None) -> torch.Tensor:
        """``rank``'s (default: this rank's) part of ``full`` -- over the
        mesh axes in ``axes`` only, when given -- as a view."""
        r = self.mesh.rank if rank is None else rank
        for dim, ax in self.split_axes(axes):
            n = full.shape[dim] // self.mesh.axes_size(ax)
            full = full.narrow(dim, self._part(r, ax) * n, n)
        return full

    def local_shape(self, shape: Sequence[int], axes=None) -> tuple[int, ...]:
        out = list(shape)
        for dim, ax in self.split_axes(axes):
            k = self.mesh.axes_size(ax)
            if out[dim] % k:
                raise ValueError(f"dim {dim} of shape {tuple(shape)} does "
                                 f"not split into {k} parts over {ax}")
            out[dim] //= k
        return tuple(out)


def logical_sharding(logical: Sequence[str | None], mesh,
                     rules: ShardingRules, device=None) -> NamedSharding:
    """NamedSharding for a tensor described only by logical axes (params:
    their def shapes are constructed divisible)."""
    return NamedSharding(mesh, rules.mesh_axes(logical, mesh), device)


def def_shardings(defs, mesh, rules: ShardingRules, device=None):
    """A ParamDef tree's NamedShardings, each from ``safe_spec`` of the
    def's shape: a dim the rule's axes do not divide stays whole."""
    from repro_torch.models.params import tree_map  # models import dist
    return tree_map(lambda d: NamedSharding(
        mesh, safe_spec(d.shape, d.logical, mesh, rules), device), defs)


def constrain(x: torch.Tensor, logical: Sequence[str | None], mesh,
              rules: ShardingRules,
              exclude_axes: Sequence[str] = ()) -> torch.Tensor:
    """The injectable model hook of the JAX package, the identity here at
    any ``model`` size: a rank's activations are whole on it (the batch is
    split before the step), and the model code places the tensor-parallel
    collectives itself (``copy_to_model`` / ``reduce_from_model``)."""
    return x


@dataclass(frozen=True, eq=False)
class ModelAxis:
    """This rank's place on its mesh's ``model`` axis (of size above 1):
    the axis size, this rank's coordinate on it and the all-reduce over
    its tensor-parallel group, counted under ``TP``."""

    mesh: PlatformMesh

    @property
    def size(self) -> int:
        return self.mesh.shape["model"]

    @property
    def coord(self) -> int:
        return self.mesh.coords()["model"]

    def all_reduce(self, x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
        """The sum (or ``reduce="max"``: the maximum) of ``x`` over the
        model axis, in a new tensor."""
        out = x.detach().contiguous().clone()
        collective(self.mesh, TP, "all_reduce", out, out,
                   self.mesh.group(("model",)), reduce)
        return out


@dataclass(frozen=True, eq=False)
class Replicas:
    """This rank's place on its mesh's batch axes (``pod``, ``data``),
    which hold more than one replica: their number, this rank's replica
    (row-major over the axes, slow to fast: the block of a batch split
    over them that its rows are) and an all-gather over their group."""

    mesh: PlatformMesh

    @property
    def axes(self) -> tuple[str, ...]:
        return batch_axes(self.mesh)

    @property
    def size(self) -> int:
        return self.mesh.axes_size(self.axes)

    @property
    def index(self) -> int:
        return batch_index(self.mesh)

    def all_gather(self, x: torch.Tensor, label: str) -> torch.Tensor:
        """(size, *x.shape): every replica's ``x``, in replica order,
        counted under ``label``."""
        shape = x.shape
        x = x.detach().contiguous().reshape(-1)
        out = torch.empty(self.size * x.numel(), dtype=x.dtype,
                          device=x.device)
        collective(self.mesh, label, "all_gather", out, x,
                   self.mesh.group(self.axes))
        return out.view(self.size, *shape)


def replicas_of(mesh: PlatformMesh | None) -> Replicas | None:
    """The ``Replicas`` of ``mesh``; ``None`` without a mesh or with one
    replica."""
    if mesh is None or mesh.axes_size(batch_axes(mesh)) == 1:
        return None
    return Replicas(mesh)


def model_axis(mesh: PlatformMesh | None) -> ModelAxis | None:
    """The ``ModelAxis`` of ``mesh``; ``None`` without a mesh or with
    ``model`` at 1."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return ModelAxis(mesh)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """Entry of a tensor-parallel region: ``x`` (whole on every rank of
    the model axis) forward, its gradient summed over the axis backward
    (each rank's region contributed its part of it)."""
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor,
                      axis: ModelAxis | None) -> torch.Tensor:
    """Exit of a tensor-parallel region: the sum of the ranks' partial
    ``x`` forward, the gradient as it is backward."""
    return x if axis is None else _ReduceFromModel.apply(x, axis)


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


def sum_over_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """The sum of the ranks' ``x`` over the model axis, where every rank's
    region goes on from the sum: its gradient is the sum of theirs (an
    all-reduce forward and backward)."""
    return x if axis is None else _SumOverModel.apply(x, axis)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        x = x.detach().contiguous()
        out = torch.empty((axis.size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        collective(axis.mesh, TP, "all_gather", out, x,
                   axis.mesh.group(("model",)))
        return out

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        g = g.contiguous()
        out = torch.empty((g.shape[0] // axis.size, *g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        collective(axis.mesh, TP, "reduce_scatter", out, g,
                   axis.mesh.group(("model",)))
        return out, None


def gather_from_model(x: torch.Tensor,
                      axis: ModelAxis | None) -> torch.Tensor:
    """The whole of a leaf split on its first dim over the model axis (the
    ranks' rows in coordinate order) forward; backward, this rank's rows of
    the sum of the ranks' gradients: each rank's region adds the gradient
    of the rows it read."""
    return x if axis is None else _GatherFromModel.apply(x, axis)


class _OnceOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.axis.coord == 0 else torch.zeros_like(g)), None


def once_over_model(x: torch.Tensor, axis: ModelAxis | None) -> torch.Tensor:
    """``x`` forward; backward, the gradient on the axis's first rank and
    zeros on the others. For rows of a ``gather_from_model`` leaf that
    replicated math reads: every rank computes the same gradient for them,
    which the reduce-scatter would otherwise sum once a rank."""
    return x if axis is None else _OnceOverModel.apply(x, axis)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, sharding, label):
        from repro_torch.core.abi import all_gather   # core.abi imports dist
        ctx.sharding, ctx.label = sharding, label
        return all_gather(part.detach(), sharding, label,
                          axes=batch_axes(sharding.mesh))

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.abi import reduce_scatter_mean
        # float32 on the wire, as the implicit path's other gradients
        return reduce_scatter_mean(g.float(), ctx.sharding,
                                   ctx.label), None, None


@dataclass(frozen=True, eq=False)
class FSDP:
    """Weight FSDP on a mesh: the params' NamedShardings (stacked leaves,
    as ``def_shardings`` gives them under ``ShardingRules.default(fsdp=
    True)``) and the label their collectives count under (the ABI's
    name)."""

    shardings: dict
    label: str

    def gather(self, params, shardings):
        """``params`` (a subtree of the param tree, its ``shardings``
        alike) with every leaf the shardings split over the batch axes
        gathered whole over them."""
        from repro_torch.models.params import tree_map

        def leaf(p, sh):
            if not sh.split(batch_axes(sh.mesh)):
                return p
            return _GatherBatch.apply(p, sh, self.label)
        return tree_map(leaf, params, shardings)

    def layer(self, stage: str):
        """The per-layer shardings of a stacked stage (its leading
        ``layers`` dim, never split, dropped)."""
        from repro_torch.models.params import tree_map
        return tree_map(lambda sh: NamedSharding(sh.mesh, sh.spec[1:],
                                                 sh.device),
                        self.shardings[stage])


def fsdp_of(mesh: PlatformMesh | None, shardings, label: str) -> FSDP | None:
    """The ``FSDP`` of a param tree's ``shardings`` on ``mesh``; ``None``
    when no leaf is split over a batch axis above 1 (FSDP off, or one
    replica)."""
    from repro_torch.models.params import tree_leaves
    if mesh is None or not any(sh.split(batch_axes(mesh))
                               for sh in tree_leaves(shardings)):
        return None
    return FSDP(shardings, label)
