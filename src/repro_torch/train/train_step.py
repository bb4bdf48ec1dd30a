"""Train steps (the port of ``repro.train.train_step``).

Two ABI-compatible step paths, as in the JAX package:

* ``implicit`` -- value-and-grad, then the AdamW update. The ``generic``
  ABI uses it (one flat fp32 gradient mean; on one process there is
  nothing to reduce).
* ``explicit`` -- the local step, then ``abi.grad_sync`` (wire dtype,
  hierarchical reductions) or PowerSGD with error feedback, then the
  update: the ``host mode=explicit`` path.

Both return ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` with metrics ``loss``, ``aux_loss``, ``grad_norm`` and ``lr``
(0-d tensors on the device; nothing is read back to the host). A batch
holds numpy arrays or tensors; the step moves them to the params'
device. Built with ``donate=True`` the update writes into the given
params and optimizer state (``jax.jit(..., donate_argnums=(0, 1))``).

Gradient accumulation: ``microbatches > 1`` runs the batch in slices and
accumulates float32 grads, divided by the count at the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.abi import CollectiveABI, replica_mean
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import Model
from repro_torch.train.compression import powersgd_sync
from repro_torch.train.optimizer import OptConfig, adamw_update

AUX_LOSS_WEIGHT = 0.01
BATCH_AXES = ("data",)    # the one replica axis of a single-card mesh


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, mask: torch.Tensor | None = None):
    """logits: (B,S,Vp) with physical padding beyond vocab_size; labels
    (B,S). Padded vocab columns are masked to -1e30 so the partition
    function is exact w.r.t. the canonical vocabulary."""
    vp = logits.shape[-1]
    lg = logits.float()
    if vp != vocab_size:
        col = torch.arange(vp, device=lg.device) >= vocab_size
        lg = lg.masked_fill(col, -1e30)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
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

    # -- loss ------------------------------------------------------------
    def _loss(self, params, batch):
        cfg = self.model.cfg
        fe = batch.get("frontend_embeds")
        logits, aux = self.model.forward(params, batch["tokens"],
                                         frontend_embeds=fe)
        labels = batch["labels"]
        if fe is not None:
            # frontend prefix carries no LM loss; labels cover token positions
            logits = logits[:, fe.shape[1]:]
        loss = cross_entropy(logits, labels, cfg.vocab_size,
                             batch.get("loss_mask"))
        return loss + AUX_LOSS_WEIGHT * aux, (loss, aux)

    def _value_and_grad(self, params, batch):
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(tracked)
        total, (loss, aux) = self._loss(tracked, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        by_leaf = {id(t): g for t, g in zip(leaves, grads)}
        return (tree_map(lambda t: by_leaf[id(t)], tracked), loss.detach(),
                aux.detach())

    def _grads(self, params, batch):
        """(possibly microbatched) value-and-grad; with microbatches the
        grads are float32."""
        if self.microbatches == 1:
            return self._value_and_grad(params, batch)
        n = self.microbatches
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lacc = aacc = 0.0
        for i in range(n):
            mb = {k: _slice(v, i, n) for k, v in batch.items()}
            g, loss, aux = self._value_and_grad(params, mb)
            for a, b in zip(tree_leaves(gacc), tree_leaves(g)):
                a.add_(b.float())
            lacc, aacc = lacc + loss, aacc + aux
        return tree_map(lambda x: x / n, gacc), lacc / n, aacc / n

    def _device(self, params) -> torch.device:
        return tree_leaves(params)[0].device

    # -- implicit path ----------------------------------------------------
    def build_implicit(self) -> Callable:
        def step(params, opt_state, batch):
            batch = _on_device(batch, self._device(params))
            grads, loss, aux = self._grads(params, batch)
            new_params, new_state, om = adamw_update(
                params, grads, opt_state, self.opt, inplace=self.donate)
            metrics = {"loss": loss, "aux_loss": aux, **om}
            return new_params, new_state, metrics

        return step

    # -- explicit path ------------------------------------------------------
    def build_explicit(self) -> Callable:
        """The local step, then the ABI's gradient sync (or PowerSGD with
        error feedback, whose state rides in ``opt_state["comm"]`` with a
        leading per-replica axis of 1), then the update."""
        use_psgd = self.abi.options.get("compression") == "powersgd"
        rank = int(self.abi.options.get("rank", 16))

        def step(params, opt_state, batch):
            batch = _on_device(batch, self._device(params))
            comm = opt_state.get("comm")
            opt_core = {k: v for k, v in opt_state.items() if k != "comm"}
            grads, loss, aux = self._grads(params, batch)
            if use_psgd and comm is not None:
                local = {"q": _map(lambda a: a[0], comm["q"]),
                         "err": _map(lambda a: a[0], comm["err"])}
                grads, local = powersgd_sync(grads, local, BATCH_AXES, rank)
                comm = {"q": _map(lambda a: a[None], local["q"]),
                        "err": _map(lambda a: a[None], local["err"])}
            else:
                # the ABI swap point: wire dtype + topology live here
                grads = self.abi.grad_sync(grads, BATCH_AXES)
            loss = replica_mean(loss, BATCH_AXES)
            aux = replica_mean(aux, BATCH_AXES)
            new_params, new_state, om = adamw_update(
                params, grads, opt_core, self.opt, inplace=self.donate)
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

