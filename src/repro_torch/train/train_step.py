"""Train steps (the port of ``repro.train.train_step``).

Two ABI-compatible step paths, as in the JAX package:

* ``implicit`` -- value-and-grad, then the AdamW update. The ``generic``
  ABI: one flat float32 all-reduce mean of the gradients, optimizer state
  replicated. ZeRO-1 (the ``host`` ABI; ``opt_shardings`` split m/v over
  the batch axes): a float32 reduce-scatter of each split leaf's
  gradient, the update of this rank's part, an all-gather of the params.
  The JAX package leaves these collectives to XLA's partitioner on this
  path, so its wire stays float32 here too.
* ``explicit`` -- the local step, then ``abi.grad_sync`` (wire dtype,
  hierarchical means) or PowerSGD with error feedback, then the update:
  the ``host mode=explicit`` path. Optimizer state stays replicated, as
  inside the JAX package's ``shard_map``.

Both return ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` with metrics ``loss``, ``aux_loss``, ``grad_norm`` and ``lr``
(0-d tensors on the device; nothing is read back to the host). A batch
is the GLOBAL batch, numpy arrays or tensors: each rank of the mesh keeps
its rows (``data.pipeline.rank_rows``) and moves them to the params'
device, so every step equals the JAX step on the same global batch over a
mesh of the same shape. Built with ``donate=True`` the update writes into
the given params and optimizer state (``jax.jit(..., donate_argnums=(0,
1))``).

Gradient accumulation: ``microbatches > 1`` runs the batch in slices and
accumulates float32 grads, divided by the count at the end.

With microbatches the implicit path's rank takes its block of each
global microbatch, as the reference slices the global batch and then
splits each slice over the replicas: the ranks' microbatch ``i`` is the
global one. Its model calls get the mesh's replicas, so an MoE layer whose
dispatch runs over the global batch (``Model.moe_replicas``) takes the
global batch's positions and capacity, as under the JAX package's GSPMD.
The explicit path takes its replica's block of the batch and slices that,
and keeps each replica's capacity over its own rows, as the reference's
manual region does.

With a ``loss_mask`` the JAX implicit loss is the global masked mean
(over each global microbatch, then averaged), which no mean of the
ranks' own masked means gives: each rank weights its microbatches by
their mask counts over the all-reduced counts of the global microbatches
(``_mask_weights``). The explicit path keeps the JAX
package's per-shard mean, then the mean over replicas.

Weight FSDP (the model carries a ``dist.sharding.FSDP``; implicit path
only): a leaf the model gathers arrives from the backward as this rank's
part of its replica mean (the gather's reduce-scatter), is not synced
again, and is updated as the part it is -- no all-gather after the
update; m/v split alike (``opt_shardings``).

On a mesh with a ``model`` axis (tensor parallelism: the model carries
the axis, the params are the rank's shards) a rank's rows are those of
its batch coordinate -- the ranks of one data replica take the same rows
-- every ABI collective runs over the batch axes' group only, the loss is
``cross_entropy`` over the vocab-parallel logits, and ``grad_norm`` is
the global norm with each shard counted once (``_global_norm``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Callable

import torch

from repro_torch.core.abi import (CollectiveABI, all_gather,
                                  reduce_scatter_mean, replica_mean)
from repro_torch.data.pipeline import rank_rows
from repro_torch.dist.mesh import (PlatformMesh, batch_axes, batch_index,
                                   collective)
from repro_torch.dist.sharding import (ModelAxis, Replicas,
                                       reduce_from_model, replicas_of)
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import Model
from repro_torch.train.compression import powersgd_sync
from repro_torch.train.optimizer import OptConfig, adamw_update

AUX_LOSS_WEIGHT = 0.01
# the label of the step's scalar means (loss, aux, ZeRO-1's norm, mask
# counts) in the mesh's collective counter, apart from the ABI's traffic
METRICS = "metrics"


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, mask: torch.Tensor | None = None,
                  axis: ModelAxis | None = None):
    """logits: (B,S,Vp) with physical padding beyond vocab_size; labels
    (B,S). Padded vocab columns are masked to -1e30 so the partition
    function is exact w.r.t. the canonical vocabulary.

    On a model axis ``logits`` are the rank's vocab slice (columns
    ``[c * Vp/tp, (c+1) * Vp/tp)``; the shard that holds padded columns
    masks them): the row max, the sum of exponentials and the gold logit
    are each all-reduced over the axis, the last two with the identity
    backward, so each rank's slice gets its own columns' gradient."""
    vp = logits.shape[-1]
    lg = logits.float()
    if axis is None:
        if vp != vocab_size:
            col = torch.arange(vp, device=lg.device) >= vocab_size
            lg = lg.masked_fill(col, -1e30)
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    else:
        lo = axis.coord * vp
        col = lo + torch.arange(vp, device=lg.device) >= vocab_size
        lg = lg.masked_fill(col, -1e30)
        m = axis.all_reduce(lg.detach().amax(dim=-1), "max")
        sumexp = reduce_from_model(torch.exp(lg - m[..., None]).sum(-1),
                                   axis)
        logz = torch.log(sumexp) + m
        local = labels.long() - lo
        mine = (local >= 0) & (local < vp)
        gold = torch.gather(lg, -1, torch.where(mine, local, 0)[..., None])
        gold = reduce_from_model(gold[..., 0].masked_fill(~mine, 0.0), axis)
    nll = logz - gold
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def _on_device(batch: dict, device: torch.device) -> dict:
    """Batch arrays as tensors on ``device``; integer arrays as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


@dataclass
class TrainStepBuilder:
    model: Model
    abi: CollectiveABI
    opt: OptConfig
    microbatches: int = 1
    donate: bool = False
    # this rank's view of the job (None: one process)
    mesh: PlatformMesh | None = None
    # ZeRO-1: m/v (and master) NamedShardings, param-shaped; None keeps
    # the optimizer state whole on every rank
    opt_shardings: dict | None = None
    # PowerSGD on a model axis: the params' NamedShardings, whose model
    # splits say how each leaf's whole matrix is compressed
    param_shardings: dict | None = None

    # -- loss ------------------------------------------------------------
    def _loss(self, params, batch, replicas: Replicas | None = None):
        cfg = self.model.cfg
        fe = batch.get("frontend_embeds")
        logits, aux = self.model.forward(params, batch["tokens"],
                                         frontend_embeds=fe,
                                         replicas=replicas)
        labels = batch["labels"]
        if fe is not None:
            # frontend prefix carries no LM loss; labels cover token positions
            logits = logits[:, fe.shape[1]:]
        loss = cross_entropy(logits, labels, cfg.vocab_size,
                             batch.get("loss_mask"), self.model.axis)
        return loss + AUX_LOSS_WEIGHT * aux, (loss, aux)

    def _value_and_grad(self, params, batch, weight=None, replicas=None):
        """Grads of the loss; with ``weight`` of ``weight * loss`` plus the
        aux loss's share of the microbatches' mean."""
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(tracked)
        total, (loss, aux) = self._loss(tracked, batch, replicas)
        if weight is not None:
            total = weight * loss + AUX_LOSS_WEIGHT * aux / self.microbatches
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads)}
        return (tree_map(lambda t: by_leaf[id(t)], tracked), loss.detach(),
                aux.detach())

    def _grads(self, params, batch, weights=None, replicas=None):
        """(possibly microbatched) value-and-grad; with microbatches the
        grads are float32. With ``weights`` (one a microbatch) grads and
        loss are the weighted sums over the microbatches, not means.
        ``replicas``: the rows are this rank's block of the global batch
        (``Model.forward``)."""
        n = self.microbatches
        if n == 1 and weights is None:
            return self._value_and_grad(params, batch, replicas=replicas)
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lacc = aacc = 0.0
        for i in range(n):
            mb = {k: _slice(v, i, n) for k, v in batch.items()}
            w = None if weights is None else weights[i]
            g, loss, aux = self._value_and_grad(params, mb, w, replicas)
            for a, b in zip(tree_leaves(gacc), tree_leaves(g)):
                a.add_(b.float())
            lacc = lacc + (loss if w is None else w * loss)
            aacc = aacc + aux
        if weights is not None:
            return gacc, lacc, aacc / n
        return tree_map(lambda x: x / n, gacc), lacc / n, aacc / n

    def _mask_weights(self, batch):
        """Replicas x each local microbatch's share of the global masked
        loss: its mask count over (microbatches x the count of its global
        microbatch), from one all-reduce of every replica's counts. ``None`` without a mask or without batch replicas."""
        mesh, n = self.mesh, self.microbatches
        if "loss_mask" not in batch or mesh is None:
            return None
        baxes = self._baxes()
        w = mesh.axes_size(baxes)
        if w == 1:
            return None
        b = batch_index(mesh)
        counts = batch["loss_mask"].float().reshape(n, -1).sum(1)
        table = torch.zeros((w, n), device=counts.device)
        table[b] = counts
        table = (replica_mean(table, baxes, mesh, METRICS) * w).round()
        # local microbatch k of every replica is global microbatch k
        return w * counts / (n * torch.clamp(table.sum(0), min=1.0))

    def _device(self, params) -> torch.device:
        return tree_leaves(params)[0].device

    def _local_batch(self, params, batch: dict,
                     explicit: bool = False) -> dict:
        """This rank's rows of the global ``batch``, on the params'
        device: its block of it on the ``explicit`` path, else its block
        of each global microbatch."""
        if self.mesh is not None:
            w, n = self.mesh.axes_size(self._baxes()), self.microbatches
            b = batch_index(self.mesh)
            if explicit or n == 1:
                batch = rank_rows(batch, b, w)
            else:
                # (n, w, rows) -> this replica's rows of each microbatch
                batch = {k: torch.as_tensor(v).reshape(
                    n, w, -1, *v.shape[1:])[:, b].reshape(-1, *v.shape[1:])
                    for k, v in batch.items()}
        return _on_device(batch, self._device(params))

    def _baxes(self) -> tuple[str, ...]:
        return batch_axes(self.mesh) if self.mesh is not None else ("data",)

    def _global_norm(self, grads) -> torch.Tensor:
        """The global norm of gradients of which this rank holds a part of
        each leaf (its model-axis shard, or under ZeRO-1 its part of
        that): each part's square weighted by the share of the ranks that
        hold it, summed over every rank in one all-reduce."""
        mesh = self.mesh
        full = [math.prod(d.shape) for d in tree_leaves(self._defs)]
        sq = torch.zeros((), dtype=torch.float32,
                         device=tree_leaves(grads)[0].device)
        for g, n in zip(tree_leaves(grads), full):
            sq = sq + g.float().square().sum() * (n / (g.numel()
                                                       * mesh.size))
        collective(mesh, METRICS, "all_reduce", sq, sq,
                   mesh.group(mesh.axis_names))
        return torch.sqrt(sq)

    @cached_property
    def _defs(self):
        return self.model.param_defs()

    # -- implicit path ----------------------------------------------------
    def build_implicit(self) -> Callable:
        def step(params, opt_state, batch):
            batch = self._local_batch(params, batch)
            if self.mesh is None or self.mesh.size == 1:
                grads, loss, aux = self._grads(params, batch)
                new_params, new_state, om = adamw_update(
                    params, grads, opt_state, self.opt, inplace=self.donate)
                return new_params, new_state, {"loss": loss,
                                               "aux_loss": aux, **om}
            return self._implicit_distributed(params, opt_state, batch)

        return step

    def _implicit_distributed(self, params, opt_state, batch):
        mesh, name, baxes = self.mesh, self.abi.name, self._baxes()
        grads, loss, aux = self._grads(params, batch,
                                       self._mask_weights(batch),
                                       replicas_of(mesh))
        loss = replica_mean(loss, baxes, mesh, METRICS)
        aux = replica_mean(aux, baxes, mesh, METRICS)
        none = tree_map(lambda p: None, params)
        shards = self.opt_shardings or none
        fsdp = self.model.fsdp.shardings if self.model.fsdp else none

        def split(sh) -> bool:      # this leaf's optimizer state is split
            return sh is not None and bool(sh.split(baxes))

        def sync(g, sh, psh):
            if split(psh):          # an FSDP part: meaned in the backward
                return g.float()
            if split(sh):
                return reduce_scatter_mean(g.float(), sh, name)
            return replica_mean(g.float(), baxes, mesh, name)

        def whole(sh, psh) -> bool:     # a whole leaf, its state split
            return split(sh) and not split(psh)

        part_g = tree_map(sync, grads, shards, fsdp)
        part_p = tree_map(lambda p, sh, psh: sh.local(p, baxes)
                          if whole(sh, psh) else p, params, shards, fsdp)
        gnorm = None
        if self.model.axis is not None or any(
                split(sh) for sh in tree_leaves(shards)):
            gnorm = self._global_norm(part_g)
        new_parts, new_state, om = adamw_update(
            part_p, part_g, opt_state, self.opt, inplace=self.donate,
            gnorm=gnorm)
        new_params = tree_map(
            lambda p, new, sh, psh: all_gather(
                new, sh, name, out=p if self.donate else None, axes=baxes)
            if whole(sh, psh) else new, params, new_parts, shards, fsdp)
        return new_params, new_state, {"loss": loss, "aux_loss": aux, **om}

    # -- explicit path ------------------------------------------------------
    def build_explicit(self) -> Callable:
        """The local step, then the ABI's gradient sync (or PowerSGD with
        error feedback, whose state rides in ``opt_state["comm"]`` with a
        leading per-replica axis holding this rank's row), then the
        update."""
        use_psgd = self.abi.options.get("compression") == "powersgd"
        rank = int(self.abi.options.get("rank", 16))
        mesh, name = self.mesh, self.abi.name

        def step(params, opt_state, batch):
            baxes = self._baxes()
            batch = self._local_batch(params, batch, explicit=True)
            comm = opt_state.get("comm")
            opt_core = {k: v for k, v in opt_state.items() if k != "comm"}
            grads, loss, aux = self._grads(params, batch)
            if use_psgd and comm is not None:
                local = {"q": _map(lambda a: a[0], comm["q"]),
                         "err": _map(lambda a: a[0], comm["err"])}
                grads, local = powersgd_sync(grads, local, baxes, rank, mesh,
                                             name, self.param_shardings)
                comm = {"q": _map(lambda a: a[None], local["q"]),
                        "err": _map(lambda a: a[None], local["err"])}
            else:
                # the ABI swap point: wire dtype + topology live here
                grads = self.abi.grad_sync(grads, baxes, mesh)
            loss = replica_mean(loss, baxes, mesh, METRICS)
            aux = replica_mean(aux, baxes, mesh, METRICS)
            gnorm = (self._global_norm(grads)
                     if self.model.axis is not None else None)
            new_params, new_state, om = adamw_update(
                params, grads, opt_core, self.opt, inplace=self.donate,
                gnorm=gnorm)
            if comm is not None:
                new_state["comm"] = comm
            metrics = {"loss": loss, "aux_loss": aux, **om}
            return new_params, new_state, metrics

        return step

    def build(self) -> Callable:
        """ABI -> step-path binding: ``host mode=explicit`` takes the
        explicit path, everything else the implicit one."""
        if self.abi.options.get("mode") == "explicit":
            return self.build_explicit()
        return self.build_implicit()


def _slice(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    mb = x.shape[0] // n
    return x[i * mb:(i + 1) * mb]


def _map(fn, tree):
    """tree_map that keeps ``None`` leaves (uncompressed PowerSGD
    leaves)."""
    return tree_map(lambda a: None if a is None else fn(a), tree)

