"""Collective ABI: runtime-swappable collective strategies (paper §3.3,
§4.2), the port of ``repro.core.abi``.

The paper's key HPC result: an image ships a *generic* MPICH; at run time
the host's ABI-compatible, vendor-optimised MPI is linked in, with no
rebuild and no source change. Here the ABI is a stable strategy interface
consumed by the train steps; images select an implementation by
name (``COLLECTIVES generic`` / ``COLLECTIVES host``), with zero model-code
change.

``generic``  -- flat fp32 gradient mean, replicated optimizer states.
``host``     -- ZeRO-1 optimizer-state sharding, bfloat16 wire dtype for
                gradient means, hierarchical (pod-then-ICI) reductions;
                ``mode=explicit`` takes ``compression=powersgd rank=R``
                (train/compression.py).

The fields and the option parsing are the JAX package's, copied. The
JAX package's ranks are devices of one process and its means are
``jax.lax.pmean`` over mesh axes; the port's ranks are processes, and its
means are ``torch.distributed`` collectives over the process groups of a
``dist.mesh.PlatformMesh``. Every collective adds what it was handed to
the mesh's ``stats`` under the ABI's name: the bytes are the Fig. 3
observable. Over one rank each mean is the identity, exactly as JAX's
``pmean`` over a size-1 axis, so ``grad_sync`` casts each gradient to the
wire dtype and back. On a mesh with a ``model`` axis every collective
here runs over the batch axes' group only (the JAX package's explicit
path is manual over the batch axes and leaves ``model`` to GSPMD): each
rank hands over its own model-axis shard, and the tensor-parallel
collectives stay on the model group (``dist.sharding``).

A gloo group moves host memory: a collective of a CUDA tensor over gloo
goes through a host copy (chosen from the mesh's backend and the tensor's
device, never by trying one and then the other).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from repro_torch.dist.mesh import (PlatformMesh, batch_axes, collective,
                                   make_mesh)
from repro_torch.models.params import tree_map


def _job_mesh(mesh: PlatformMesh | None) -> PlatformMesh | None:
    """``mesh``, or without one the job's local mesh (every rank on
    ``data``) when this process is one rank of several."""
    dist = torch.distributed
    if mesh is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return make_mesh((dist.get_world_size(), 1), ("data", "model"))
    return mesh


def replica_mean(x: torch.Tensor, batch_axes: Sequence[str] = (),
                 mesh: PlatformMesh | None = None, abi: str = "generic"):
    """Mean of ``x`` over the replicas along ``batch_axes`` of ``mesh``
    (default: the job's local mesh), in ``x``'s dtype; the identity where
    those axes hold one rank."""
    mesh = _job_mesh(mesh)
    if mesh is None or mesh.axes_size(batch_axes) == 1:
        return x
    out = x.detach().clone()
    collective(mesh, abi, "all_reduce", out, out, mesh.group(batch_axes))
    return out.div_(mesh.axes_size(batch_axes))


def reduce_scatter_mean(x: torch.Tensor, sharding, abi: str = "host"):
    """This rank's part of the mean of ``x`` over the ranks of its batch
    axes' group: one reduce-scatter of the whole tensor. ``sharding`` (a
    ``dist.sharding.NamedSharding``) names the part by the dims it splits
    over the batch axes; ``x`` is this rank's tensor as it stands, so on a
    mesh with a ``model`` axis it is the rank's model-axis shard."""
    mesh = sharding.mesh
    baxes = batch_axes(mesh)
    members = mesh.members(baxes)
    rows = torch.stack([sharding.local(x, baxes, r).reshape(-1)
                        for r in members])
    out = torch.empty(rows.shape[1], dtype=x.dtype, device=x.device)
    collective(mesh, abi, "reduce_scatter", out, rows.reshape(-1),
                mesh.group(baxes))
    return out.div_(len(members)).view(sharding.local_shape(x.shape, baxes))


def all_gather(part: torch.Tensor, sharding, abi: str = "host",
               out: torch.Tensor | None = None, axes=None) -> torch.Tensor:
    """The inverse of ``sharding.local(full, axes)``: the tensor whole
    along the dims ``sharding`` splits over the mesh axes in ``axes``
    (default: every axis it splits over), from the parts of the ranks
    that differ from this one along them; written into ``out`` when
    given."""
    mesh = sharding.mesh
    if axes is None:
        axes = tuple(a for _, ax in sharding.split_axes() for a in ax)
    members = mesh.members(axes)
    src = part.contiguous().reshape(-1)
    buf = torch.empty(len(members) * src.numel(), dtype=part.dtype,
                      device=part.device)
    collective(mesh, abi, "all_gather", buf, src, mesh.group(axes))
    buf = buf.view(len(members), *part.shape)
    shape = list(part.shape)
    for dim, ax in sharding.split_axes(axes):
        shape[dim] *= mesh.axes_size(ax)
    full = out if out is not None else torch.empty(
        shape, dtype=part.dtype, device=part.device)
    for i, r in enumerate(members):
        sharding.local(full, axes, r).copy_(buf[i])
    return full


@dataclass(frozen=True)
class CollectiveABI:
    """Stable interface contract between train steps and collective
    implementations: ``zero1`` decides optimizer-state placement on the
    implicit path; ``grad_sync`` is the explicit path's cross-replica
    reduction."""

    name: str
    zero1: bool = False
    grad_dtype: str = "float32"       # wire dtype for gradient sums
    hierarchical: bool = False        # two-level (pod-aware) reductions
    error_feedback: bool = False      # residual feedback for lossy compression
    options: dict = field(default_factory=dict)

    # ---- explicit path ---------------------------------------------------
    def grad_sync(self, grads, batch_axes: Sequence[str],
                  mesh: PlatformMesh | None = None):
        """Cross-replica mean of the gradient tree over ``batch_axes`` of
        ``mesh``, sent in ``grad_dtype``; with ``hierarchical`` one mean
        per axis, in the order given (the JAX package passes
        ``batch_axes(mesh)``: pod, then data)."""
        wire = getattr(torch, self.grad_dtype)

        def sync(g):
            orig = g.dtype
            g = g.to(wire)
            if self.hierarchical and len(batch_axes) > 1:
                for ax in batch_axes:
                    g = replica_mean(g, (ax,), mesh, self.name)
            else:
                g = replica_mean(g, tuple(batch_axes), mesh, self.name)
            return g.to(orig)

        return tree_map(sync, grads)

    # ---- implicit path hints ----------------------------------------------
    def opt_state_batch_spec(self, batch_axes: Sequence[str]):
        """Mesh axes over which 1st-moment/2nd-moment/master params shard.

        ZeRO-1: shard over all batch axes. Generic: replicate (None).
        """
        return tuple(batch_axes) if self.zero1 else None

    def describe(self) -> str:
        bits = [self.name]
        if self.zero1:
            bits.append("zero1(RS+AG)")
        if self.grad_dtype != "float32":
            bits.append(f"wire={self.grad_dtype}")
        if self.hierarchical:
            bits.append("hierarchical")
        return "+".join(bits)


# ---------------------------------------------------------------------------
# The two shipped implementations + a registry so images select by name.
# ---------------------------------------------------------------------------

def make_abi(name: str, **options: Any) -> CollectiveABI:
    if name == "generic":
        # container MPICH: nothing clever, correct everywhere.
        return CollectiveABI(name="generic", options=options)
    if name == "host":
        # Cray MPI: every vendor trick on by default; image options can
        # switch individual tricks off (e.g. grad_compression=float32).
        return CollectiveABI(
            name="host",
            zero1=bool(options.pop("zero1", True)),
            grad_dtype=str(options.pop("grad_compression", "bfloat16")),
            hierarchical=bool(options.pop("hierarchical", True)),
            error_feedback=bool(options.pop("error_feedback", False)),
            options=options,
        )
    raise ValueError(f"unknown collective ABI {name!r} (have: generic, host)")


def abi_from_image_config(cfg: dict) -> CollectiveABI:
    c = dict(cfg.get("collectives") or {"name": "generic"})
    return make_abi(c.pop("name"), **c)
