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
wire dtype and back.

A gloo group moves host memory: a collective of a CUDA tensor over gloo
goes through a host copy (chosen from the mesh's backend and the tensor's
device, never by trying one and then the other).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from repro_torch.dist.mesh import PlatformMesh, batch_axes, make_mesh
from repro_torch.models.params import tree_map

_RING = {"all_reduce": 2, "reduce_scatter": 1, "all_gather": 1}


def _job_mesh(mesh: PlatformMesh | None) -> PlatformMesh | None:
    """``mesh``, or without one the job's local mesh (every rank on
    ``data``) when this process is one rank of several."""
    dist = torch.distributed
    if mesh is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return make_mesh((dist.get_world_size(), 1), ("data", "model"))
    return mesh


def _collective(mesh: PlatformMesh, abi: str, op: str, out: torch.Tensor,
                inp: torch.Tensor, group) -> None:
    """Run ``op`` from ``inp`` into ``out`` (the same tensor for an
    all-reduce, which sums) over ``group``, staged through host memory
    where a gloo group meets a CUDA tensor; time it and count its bytes
    (``CollectiveStats``)."""
    dist = torch.distributed
    staged = mesh.backend == "gloo" and inp.is_cuda
    if inp.is_cuda:
        torch.cuda.synchronize(inp.device)
    t0 = time.perf_counter()
    i = inp.cpu() if staged else inp
    if op == "all_reduce":
        o = i
        dist.all_reduce(o, group=group)
    else:
        o = torch.empty_like(out, device="cpu") if staged else out
        fn = (getattr(dist, f"{op}_single", None)      # newer torch's name
              or getattr(dist, {"reduce_scatter": "reduce_scatter_tensor",
                                "all_gather": "all_gather_into_tensor"}[op]))
        fn(o, i, group=group)
    if staged:
        out.copy_(o)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    nbytes = (out if op == "all_gather" else inp).nbytes * _RING[op]
    mesh.stats.add(abi, op, nbytes, time.perf_counter() - t0)


def replica_mean(x: torch.Tensor, batch_axes: Sequence[str] = (),
                 mesh: PlatformMesh | None = None, abi: str = "generic"):
    """Mean of ``x`` over the replicas along ``batch_axes`` of ``mesh``
    (default: the job's local mesh), in ``x``'s dtype; the identity where
    those axes hold one rank."""
    mesh = _job_mesh(mesh)
    if mesh is None or mesh.axes_size(batch_axes) == 1:
        return x
    out = x.detach().clone()
    _collective(mesh, abi, "all_reduce", out, out, mesh.group(batch_axes))
    return out.div_(mesh.axes_size(batch_axes))


def reduce_scatter_mean(x: torch.Tensor, sharding, abi: str = "host"):
    """This rank's part (``sharding``: a ``dist.sharding.NamedSharding``
    that splits one dim over every rank's batch axes) of the mean of ``x``
    over all ranks: one reduce-scatter of the whole tensor."""
    mesh = sharding.mesh
    dim, parts, owners = sharding.split()
    rows = x.movedim(dim, 0).reshape(parts, -1)
    if owners != list(range(mesh.size)):
        rows = rows[owners]          # ranks sharing a part each get a copy
    out = torch.empty(rows.shape[1], dtype=x.dtype, device=x.device)
    _collective(mesh, abi, "reduce_scatter", out, rows.reshape(-1),
                mesh.group(batch_axes(mesh)))
    shape = list(x.shape)
    shape[dim] //= parts
    moved = [shape[dim]] + shape[:dim] + shape[dim + 1:]
    return out.div_(mesh.size).view(moved).movedim(0, dim).contiguous()


def all_gather(part: torch.Tensor, sharding, abi: str = "host",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The whole tensor from every rank's ``part`` (the inverse of
    ``sharding.local``), written into ``out`` when given."""
    mesh = sharding.mesh
    dim, parts, owners = sharding.split()
    src = part.movedim(dim, 0).contiguous().reshape(-1)
    buf = torch.empty(mesh.size * src.numel(), dtype=part.dtype,
                      device=part.device)
    _collective(mesh, abi, "all_gather", buf, src,
                mesh.group(batch_axes(mesh)))
    rows = buf.view(mesh.size, -1)
    if owners != list(range(mesh.size)):
        rows = rows[[owners.index(i) for i in range(parts)]]
    moved = [part.shape[dim] * parts] + [
        n for i, n in enumerate(part.shape) if i != dim]
    full = rows.reshape(moved).movedim(0, dim)
    if out is None:
        return full.contiguous()
    return out.copy_(full)


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
