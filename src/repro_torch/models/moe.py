"""Mixture-of-Experts: top-k routing with capacity-based scatter dispatch.

The single-device formulation of ``repro.models.moe``, in plain PyTorch:

  1. router logits -> top-k experts + renormalised weights per token;
  2. position-in-expert via a cumsum over the token-major (T*k, E)
     one-hot; assignments beyond ``capacity = cf * T * k / E`` are dropped
     (GShard-style), so the order of the rows decides who drops;
  3. scatter the kept rows into an (E, C, D) expert buffer;
  4. batched expert GEMMs ``ecd,edf->ecf`` (``torch.bmm``);
  5. gather back + weighted combine over the k choices.

The JAX package computes steps 3-5 outside any Pallas kernel (it has no
MoE kernel), and so does the port. Shared experts (DeepSeekMoE /
Moonlight / Llama-4) run as a dense MLP branch of width
``n_shared * expert_d_ff`` added to the routed output.

Two points keep the port's routing identical to the reference's:

* ties: ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities (common when the router product runs in bfloat16);
  ``torch.topk`` promises no order, so the top k come from a stable
  descending sort;
* dispatch: every kept (expert, position) slot receives exactly one row,
  and a dropped row adds zeros in the reference, so copying the kept rows
  (``index_copy_``, dropped rows sent to a discarded spare row) equals its
  ``.at[slot].add`` and is deterministic on the card, with no host sync.

The expert-parallel ``moe_forward_spmd`` and ``moe_param_specs`` come with
the port's tensor and expert parallelism (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, mlp_defs
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ModelConfig) -> dict:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    d: dict = {
        "router": ParamDef((D, E), ("embed", None), "small_normal"),
        "experts": {
            "wg": ParamDef((E, D, Fd), ("experts", "embed", "mlp")),
            "wu": ParamDef((E, D, Fd), ("experts", "embed", "mlp")),
            "wd": ParamDef((E, Fd, D), ("experts", "mlp", "embed")),
        },
    }
    if cfg.n_shared_experts:
        d["shared"] = mlp_defs(cfg, d_ff=cfg.n_shared_experts * Fd)
    return d


def _router(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (T, D) -> (idx (T,k) int64, weight (T,k) f32, aux_loss scalar)."""
    logits = (x @ p["router"].to(x.dtype)).float()              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: equal probabilities keep the lower index
    # first, as jax.lax.top_k orders them
    weight, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weight, idx = weight[:, :cfg.top_k], idx[:, :cfg.top_k]
    weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing auxiliary loss
    E = cfg.n_experts
    me = probs.mean(0)                                           # (E,)
    # counts as a one-hot sum: exact, and no host sync on the card (a CUDA
    # bincount reads the max index back first)
    ce = F.one_hot(idx.reshape(-1), E).sum(0).float() / idx.numel()
    aux = E * torch.sum(me * ce)
    return idx, weight, aux


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8 for lane alignment


def dispatch_positions(idx: torch.Tensor, n_experts: int, C: int):
    """idx (T, k) -> (pos, keep, slot), each (T*k,): the assignment's
    position in its expert (counted in token-major order), whether it fits
    the capacity ``C``, and its row of the (E*C, D) buffer (row ``e*C``
    for a dropped one, as in the reference)."""
    flat_e = idx.reshape(-1)                                     # (T*k,)
    onehot = F.one_hot(flat_e, n_experts)                        # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot                   # from 0
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot = flat_e * C + torch.where(keep, pos, torch.zeros_like(pos))
    return pos, keep, slot


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,D) -> (B,S,D), aux_loss. Capacity comes from T = B*S of
    this call, so the right-pad rows of a bucketed prefill and the idle
    slots of a decode step route and count exactly as in the reference."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, D)

    idx, weight, aux = _router(p, xt, cfg)                       # (T,k)
    _, keep, slot = dispatch_positions(idx, E, C)

    # ---- dispatch: each kept row to its own slot; dropped rows go to the
    # spare row E*C, which is cut off
    dest = torch.where(keep, slot, torch.full_like(slot, E * C))
    src = torch.repeat_interleave(xt, k, dim=0)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, src)
    buf = buf[:E * C].reshape(E, C, D)

    # ---- expert compute: batched GEMMs over the expert axis
    we = p["experts"]
    h = F.silu(torch.bmm(buf, we["wg"].to(x.dtype)))
    h = h * torch.bmm(buf, we["wu"].to(x.dtype))
    out_buf = torch.bmm(h, we["wd"].to(x.dtype))

    # ---- combine: gather back + weighted sum over k
    gathered = out_buf.reshape(E * C, D)[slot]                   # (T*k, D)
    gathered = gathered * (weight.reshape(-1)[:, None].to(x.dtype)
                           * keep[:, None].to(x.dtype))
    y = gathered.reshape(T, k, D).sum(dim=1)

    if cfg.n_shared_experts:
        y = y + apply_mlp(p["shared"], xt, cfg.mlp)
    return y.reshape(B, S, D), aux
