"""AdamW with global-norm clipping and a warmup-cosine schedule (the port of
``repro.train.optimizer``).

State = {m, v} float32 trees shaped like params, plus a scalar int32
``step`` tensor, and an optional float32 ``master`` copy of params (mixed
precision: params may live in bfloat16). Tree keys are the JAX package's,
so a state moves between the packages leaf for leaf.

The update runs under ``torch.no_grad()`` as plain tensor ops over the
leaves (the JAX package leaves it to XLA, not to a kernel). With
``inplace=True`` -- the counterpart of ``donate_argnums`` -- it writes the
new params, m, v, master and step into the given tensors: at llama3.2-3b's
full width params, grads, m and v are 51 GB in float32, and keeping old
and new copies of three of them at once would not fit one 80 GB card.
Without it the inputs are copied first, so both paths run the same
arithmetic. Schedule, clip factor and bias corrections stay on the
tensors' device: a step reads nothing back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = cfg.lr * torch.clamp((step + 1.0) / max(1, cfg.warmup_steps),
                                max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def adamw_init(params, with_master: bool = False) -> dict:
    """with_master: keep a float32 master copy in the optimizer (params may
    then live in bfloat16)."""
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    st = {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if with_master:
        st["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return st


def global_norm(tree) -> torch.Tensor:
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in tree_leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: OptConfig,
                 inplace: bool = False, gnorm: torch.Tensor | None = None):
    """Returns (new_params, new_state, metrics). If the state carries a
    float32 ``master`` tree, updates apply to it and params are its cast.
    ``inplace`` writes the results into ``params`` and ``state``. ``gnorm``
    is the gradients' global norm where ``grads`` hold only a part of
    them (a ZeRO-1 shard: train_step.py); by default ``grads``' own."""
    keys = [k for k in ("m", "v", "step", "master") if k in state]
    state = {k: state[k] for k in keys}
    if not inplace:
        copy = lambda t: t.detach().clone()
        params = tree_map(copy, params)
        state = {k: tree_map(copy, v) for k, v in state.items()}
    step = state["step"]
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** (step.float() + 1)
    c2 = 1.0 - b2 ** (step.float() + 1)

    masters = state.get("master")
    flat_p = tree_leaves(params)
    flat_b = tree_leaves(masters) if masters is not None else flat_p
    for p, g, m, v, base in zip(flat_p, tree_leaves(grads),
                                tree_leaves(state["m"]),
                                tree_leaves(state["v"]), flat_b):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g.square_(), alpha=1 - b2)
        delta = (m / c1).div_((v / c2).sqrt_().add_(cfg.eps))
        b32 = base if base.dtype == torch.float32 else base.float()
        delta.add_(b32, alpha=cfg.weight_decay)
        b32.sub_(delta.mul_(lr))
        if b32 is not base:
            base.copy_(b32)
        if base is not p:
            p.copy_(base)
    step.add_(1)
    return params, state, {"grad_norm": gnorm, "lr": lr}
