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

Expert parallelism (``moe_forward_spmd``) is the reference's shard_map
body ``_moe_local`` run by each rank of a ``model`` axis, on the shards
``moe_param_specs`` names: E/tp experts a rank (offset ``coord * E/tp``),
capacity from the rank's data-local tokens, the router replicated,
dropped and non-local assignments sent to an out-of-range slot, the
shared experts split on F, and one all-reduce over ``model``.

The global-capacity dispatch (``replicas``: a ``dist.sharding.Replicas``,
given where this call's rows are the rank's block of a batch split over
the mesh's batch axes): the reference's ``moe_forward`` under GSPMD sees
the GLOBAL batch -- one cumsum over every replica's tokens in the global
row order, and capacity from the global T -- wherever its expert-parallel
region does not run (a ``model`` axis of 1, ``moe_impl`` other than
``spmd``, or E % tp). A rank holds rows ``[i * B_l, (i + 1) * B_l)`` of
the batch (replica ``i``), so the global order is the replicas' order:
each rank all-gathers every replica's per-expert assignment counts (E
ints, counted under ``MOE``), starts its positions in each expert at the
sum over the replicas before it, and keeps an assignment whose global
position is below ``C = capacity(cfg, T * replicas)``. A kept position is
below C, so each rank's rows take their global slots of the (E, C, D)
buffer and run through the experts (whole on every rank, or this rank's
experts on a model axis). ``aux`` is ``E * sum_e(me_e * ce_e)`` with
``ce`` the global share of assignments and ``me`` the rank's own mean of
``probs``: the train step's mean over the replicas gives the global
``me`` -- and, as only ``me`` carries a gradient, linear in each rank's
tokens, the gradient of the global ``aux``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (ModelAxis, Replicas, copy_to_model,
                                       reduce_from_model)
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


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as its CUDA kernel computes it (zeros, then a
    scatter of ones), on every device: the CPU's first checks the indices'
    range on the host, which a ``meta`` trace cannot, so the three would
    run different operators for the same integers."""
    out = torch.zeros((*idx.shape, n), dtype=torch.int64, device=idx.device)
    return out.scatter_(-1, idx[..., None], 1)


MOE = "moe"     # the global dispatch's count gather in CollectiveStats


def _route(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (T, D) -> (idx (T,k) int64, weight (T,k) f32, probs (T,E))."""
    logits = (x @ p["router"].to(x.dtype)).float()              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: equal probabilities keep the lower index
    # first, as jax.lax.top_k orders them
    weight, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weight, idx = weight[:, :cfg.top_k], idx[:, :cfg.top_k]
    weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-9)
    return idx, weight, probs


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Assignments an expert, as a one-hot sum: exact, and no host sync on
    the card (a CUDA bincount reads the max index back first)."""
    return _one_hot(idx.reshape(-1), n).sum(0)


def _aux(probs: torch.Tensor, counts: torch.Tensor, n_assign: int,
         cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    me = probs.mean(0)                                           # (E,)
    ce = counts.float() / n_assign
    return cfg.n_experts * torch.sum(me * ce)


def _router(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (T, D) -> (idx (T,k) int64, weight (T,k) f32, aux_loss scalar)."""
    idx, weight, probs = _route(p, x, cfg)
    return idx, weight, _aux(probs, _counts(idx, cfg.n_experts),
                             idx.numel(), cfg)


def _routing(p, x: torch.Tensor, cfg: ModelConfig,
             replicas: Replicas | None):
    """``_router`` -> (idx, weight, aux, before): with ``replicas`` the
    assignments an expert of the replicas before this one (``None``
    without) and ``aux`` from the global counts (module docstring)."""
    if replicas is None:
        return (*_router(p, x, cfg), None)
    idx, weight, probs = _route(p, x, cfg)
    table = replicas.all_gather(_counts(idx, cfg.n_experts), MOE)
    before = table[:replicas.index].sum(0)
    aux = _aux(probs, table.sum(0), idx.numel() * replicas.size, cfg)
    return idx, weight, aux, before


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8 for lane alignment


def dispatch_positions(idx: torch.Tensor, n_experts: int, C: int,
                       before: torch.Tensor | None = None):
    """idx (T, k) -> (pos, keep, slot), each (T*k,): the assignment's
    position in its expert (counted in token-major order, after
    ``before[e]`` assignments of the replicas ahead of this one where
    given), whether it fits the capacity ``C``, and its row of the (E*C,
    D) buffer (row ``e*C`` for a dropped one, as in the reference)."""
    flat_e = idx.reshape(-1)                                     # (T*k,)
    onehot = _one_hot(flat_e, n_experts)                        # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot                   # from 0
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    if before is not None:
        pos = pos + before[flat_e]
    keep = pos < C
    slot = flat_e * C + torch.where(keep, pos, torch.zeros_like(pos))
    return pos, keep, slot


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                replicas: Replicas | None = None):
    """x: (B,S,D) -> (B,S,D), aux_loss. Capacity comes from T = B*S of
    this call (times the replicas with ``replicas``: the global-capacity
    dispatch), so the right-pad rows of a bucketed prefill and the idle
    slots of a decode step route and count exactly as in the reference."""
    y, aux = _moe_routed(p, x, cfg, replicas)
    if cfg.n_shared_experts:
        B, S, D = x.shape
        y = y + apply_mlp(p["shared"], x.reshape(B * S, D),
                          cfg.mlp).reshape(B, S, D)
    return y, aux


def _moe_routed(p: dict, x: torch.Tensor, cfg: ModelConfig,
                replicas: Replicas | None = None):
    """``moe_forward`` without the shared experts."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T * (replicas.size if replicas else 1))
    xt = x.reshape(T, D)

    idx, weight, aux, before = _routing(p, xt, cfg, replicas)    # (T,k)
    _, keep, slot = dispatch_positions(idx, E, C, before)

    # ---- dispatch: each kept row to its own slot; dropped rows go to the
    # spare row E*C, which is cut off
    dest = torch.where(keep, slot, torch.full_like(slot, E * C))
    src = torch.repeat_interleave(xt, k, dim=0)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, src)
    buf = buf[:E * C].reshape(E, C, D)

    out_buf = _experts(buf, p["experts"], x.dtype)

    # ---- combine: gather back + weighted sum over k
    gathered = out_buf.reshape(E * C, D)[slot]                   # (T*k, D)
    gathered = gathered * (weight.reshape(-1)[:, None].to(x.dtype)
                           * keep[:, None].to(x.dtype))
    return gathered.reshape(T, k, D).sum(dim=1).reshape(B, S, D), aux


def _experts(buf: torch.Tensor, we: dict, dt: torch.dtype) -> torch.Tensor:
    """The expert GEMMs over an (E, C, D) buffer: batched over E."""
    h = F.silu(torch.bmm(buf, we["wg"].to(dt)))
    h = h * torch.bmm(buf, we["wu"].to(dt))
    return torch.bmm(h, we["wd"].to(dt))


# ---------------------------------------------------------------------------
# expert parallelism over the model axis
# ---------------------------------------------------------------------------

def moe_param_specs(cfg: ModelConfig, model_axis: str = "model") -> dict:
    """The mesh spec of each leaf of one MoE block's params on a rank (the
    reference's shard_map in_specs, as spec tuples): the router whole,
    the experts split on E, the shared experts on F."""
    d: dict = {
        "router": (None, None),
        "experts": {"wg": (model_axis, None, None),
                    "wu": (model_axis, None, None),
                    "wd": (model_axis, None, None)},
    }
    if cfg.n_shared_experts:
        d["shared"] = {"wg": (None, model_axis), "wu": (None, model_axis),
                       "wd": (model_axis, None)}
    return d


def moe_forward_spmd(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     axis: ModelAxis, replicas: Replicas | None = None):
    """x: (B_local, S, D) -> (B_local, S, D), aux_loss, on one rank of a
    model axis whose ``p`` holds this rank's shards (``moe_param_specs``).

    The routing (router product, top k, positions in each expert, drops,
    aux) is replicated math outside the region, as in the reference; the
    tokens and the routing weights enter it, each rank scatters only its
    own experts' kept assignments into an (E/tp, C, D) buffer, runs its
    experts and its F columns of the shared experts, and the one
    all-reduce over ``model`` sums the partial outputs. ``aux`` is this
    rank's data shard's; the train step averages it over the batch axes
    (the reference's ``pmean``).

    The reference falls back to ``moe_forward`` when ``E % tp`` (or the
    batch, which the port's rows always split) does not divide: its
    semantics, not a device fallback. Here that is the routed experts
    whole on every rank (the specs leave them replicated) and the shared
    experts split on F, with capacity over the global batch (``replicas``
    where this rank's rows are its replica's block of it).

    With ``replicas`` and E % tp == 0 (``moe_impl`` other than ``spmd``,
    whose reference is GSPMD's ``moe_forward`` over the global batch)
    the positions and capacity are the global dispatch's and the experts
    stay split over the axis."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    if E % axis.size:
        y, aux = _moe_routed(p, x, cfg, replicas)
        if cfg.n_shared_experts:
            y = y + apply_mlp(p["shared"], x.reshape(T, D), cfg.mlp,
                              axis).reshape(B, S, D)
        return y, aux
    el = E // axis.size
    off = axis.coord * el
    C = capacity(cfg, T * (replicas.size if replicas else 1))
    xt = x.reshape(T, D)

    idx, weight, aux, before = _routing(p, xt, cfg, replicas)  # replicated
    pos, keep, _ = dispatch_positions(idx, E, C, before)
    flat_e = idx.reshape(-1)
    ok = keep & (flat_e >= off) & (flat_e < off + el)
    # out-of-range slot for dropped/non-local assignments
    slot = torch.where(ok, (flat_e - off) * C + pos,
                       torch.full_like(flat_e, el * C))

    xin = copy_to_model(xt, axis)
    win = copy_to_model(weight, axis)
    buf = torch.zeros((el * C + 1, D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, torch.repeat_interleave(xin, k, dim=0))
    out_buf = _experts(buf[:el * C].reshape(el, C, D), p["experts"],
                       x.dtype)
    # the out-of-range slot reads a zero row (the reference's fill value)
    rows = torch.cat([out_buf.reshape(el * C, D),
                      out_buf.new_zeros((1, D))])
    gathered = rows[slot] * (win.reshape(-1)[:, None].to(x.dtype)
                             * ok[:, None].to(x.dtype))
    y = gathered.reshape(T, k, D).sum(dim=1)

    if cfg.n_shared_experts:
        sh = p["shared"]
        hs = (F.silu(xin @ sh["wg"].to(x.dtype))
              * (xin @ sh["wu"].to(x.dtype)))             # (T, F_local)
        y = y + hs @ sh["wd"].to(x.dtype)                  # partial over F
    y = reduce_from_model(y, axis)                         # the one collective
    return y.reshape(B, S, D), aux
