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

The fields and the option parsing are the JAX package's, copied. On one
process the cross-replica mean is the identity, exactly as JAX's ``pmean``
over a size-1 axis, so ``grad_sync`` casts each gradient to the wire dtype
and back. Where ``torch.distributed`` runs more than one process the means
raise: multi-process sync, ZeRO-1 and FSDP come with ROADMAP.md Queue 1
item 11.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from repro_torch.models.params import tree_map

_DISTRIBUTED = ("multi-process gradient sync is not ported yet (ROADMAP.md "
                "Queue 1 item 11: training and distribution)")


def replica_mean(x: torch.Tensor, batch_axes: Sequence[str] = ()):
    """Mean of ``x`` over the replicas of ``batch_axes``: the identity on
    one process; raises where ``torch.distributed`` has a world size above
    1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(_DISTRIBUTED)
    return x


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
    def grad_sync(self, grads, batch_axes: Sequence[str]):
        """Cross-replica mean of the gradient tree over ``batch_axes``
        (ordered fast-to-slow), sent in ``grad_dtype``."""
        wire = getattr(torch, self.grad_dtype)

        def sync(g):
            orig = g.dtype
            g = g.to(wire)
            if self.hierarchical and len(batch_axes) > 1:
                # reduce over the fast links first, then the slow ones
                for ax in batch_axes:
                    g = replica_mean(g, (ax,))
            else:
                g = replica_mean(g, tuple(batch_axes))
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
