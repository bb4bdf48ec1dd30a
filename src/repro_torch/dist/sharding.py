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
the part of a tensor at its coordinates along the spec's axes. With the
``model`` axis at 1 (all this port runs, dist/mesh.py) at most one dim of
a tensor is split, over the batch axes: ZeRO-1's optimizer state and
PowerSGD's per-replica rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from repro_torch.dist.mesh import TENSOR_PARALLEL, PlatformMesh

Rule = str | tuple[str, ...] | None
Spec = tuple

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

    def split(self) -> tuple[int | None, int, list[int]]:
        """(dim, parts, part of each rank): the one dim the spec splits
        over mesh axes of size above 1 (``None`` and 1 part when it
        splits none); rank r holds part ``owners[r]``, its coordinates
        along that dim's axes read row-major."""
        split = [(i, tuple(a for a in _axes_of(e) if self.mesh.shape[a] > 1))
                 for i, e in enumerate(self.spec)]
        split = [(i, axes) for i, axes in split if axes]
        if not split:
            return None, 1, [0] * self.mesh.size
        if len(split) > 1:
            raise NotImplementedError(TENSOR_PARALLEL)
        dim, axes = split[0]
        owners = []
        for r in range(self.mesh.size):
            c, idx = self.mesh.coords(r), 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + c[a]
            owners.append(idx)
        return dim, self.mesh.axes_size(axes), owners

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full`` (a view)."""
        dim, parts, owners = self.split()
        if dim is None:
            return full
        n = full.shape[dim] // parts
        return full.narrow(dim, owners[self.mesh.rank] * n, n)

    def local_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        dim, parts, _ = self.split()
        out = list(shape)
        if dim is not None:
            out[dim] //= parts
        return tuple(out)


def logical_sharding(logical: Sequence[str | None], mesh,
                     rules: ShardingRules, device=None) -> NamedSharding:
    """NamedSharding for a tensor described only by logical axes (params:
    their def shapes are constructed divisible)."""
    return NamedSharding(mesh, rules.mesh_axes(logical, mesh), device)


def def_shardings(defs, mesh, rules: ShardingRules, device=None):
    """A ParamDef tree's NamedShardings, each from ``safe_spec`` of the
    def's shape: a dim the rule's axes do not divide stays whole."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda d: NamedSharding(
        mesh, safe_spec(d.shape, d.logical, mesh, rules), device), defs)


def constrain(x: torch.Tensor, logical: Sequence[str | None], mesh,
              rules: ShardingRules,
              exclude_axes: Sequence[str] = ()) -> torch.Tensor:
    """The injectable model hook: with ``model`` at 1 every activation is
    whole on its rank (the batch is split before the step), so this is
    the identity; a mesh with ``model`` above 1 is not ported."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(TENSOR_PARALLEL)
    return x
