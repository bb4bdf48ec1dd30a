"""Parameter definition trees: one source of truth for shape and init.

Every module describes its parameters as a tree (nested dicts) of
``ParamDef`` (shape + logical axes + init law). From that tree the port
derives materialised params (``materialize``) and stacked per-layer params
(``stack_defs``: a leading (L, ...) axis, as in the JAX package).

``params_from_jax`` takes the JAX package's ``Container.init_params`` tree
(as numpy arrays) and returns the port's tree: the layouts are the same, so
the hand-off is a copy, never a transpose. A def's logical axes give its
sharding (``dist.sharding.def_shardings``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "fan_in"      # fan_in | normal | zeros | ones | small_normal
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (None subtrees kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in sorted-key order (jax's dict order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def stack_defs(tree, n: int):
    """Prepend a 'layers' axis of size n to every ParamDef."""
    return tree_map(
        lambda d: replace(d, shape=(n, *d.shape), logical=("layers", *d.logical)),
        tree)


def _fan_in(shape: tuple[int, ...]) -> int:
    """Product of all dims except the last, as the JAX package computes it
    (the leading layer axis of stacked defs included)."""
    return max(1, math.prod(shape[:-1]) if len(shape) > 1 else shape[0])


def _draw(d: ParamDef, shape: tuple[int, ...], gen: torch.Generator,
          device: torch.device) -> torch.Tensor:
    """A float32 draw of ``shape`` (the whole leaf or one layer of it) from
    ``d``'s law; ``fan_in`` always comes from the whole leaf's shape."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    if d.init == "normal":
        x.normal_(0.0, d.scale, generator=gen)
    elif d.init == "small_normal":
        x.normal_(0.0, 0.02 * d.scale, generator=gen)
    elif d.init == "fan_in":
        # truncated normal at 2 std, std = scale / sqrt(fan_in)
        std = d.scale / math.sqrt(_fan_in(d.shape))
        torch.nn.init.trunc_normal_(x, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=gen)
    else:
        raise ValueError(f"unknown init {d.init!r}")
    return x


def _init_one(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.logical and d.logical[0] == "layers":
        # a stacked leaf is drawn one layer at a time into the target
        # dtype: the float32 temporary is one layer, never the whole leaf
        # (moonshot's experts are 47 x 64 x 2048 x 1408)
        out = torch.empty(d.shape, dtype=dtype, device=device)
        for i in range(d.shape[0]):
            out[i] = _draw(d, d.shape[1:], gen, device)
        return out
    return _draw(d, d.shape, gen, device).to(dtype)


def materialize(tree, seed: int, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu", keep=None):
    """Instantiate a ParamDef tree from one ``torch.Generator`` seeded with
    ``seed`` on ``device``, leaves drawn in sorted-key order. The draws
    follow the JAX package's distributions, not its numbers (torch cannot
    replay jax's per-leaf ``fold_in``). ``keep(def, leaf)``, when given,
    maps each whole leaf as it is drawn to what is kept (a rank's part),
    so no more than one whole leaf lives at a time."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    made = {}
    for d in tree_leaves(tree):
        t = _init_one(d, gen, dtype, device)
        made[id(d)] = t if keep is None else keep(d, t)
    return tree_map(lambda d: made[id(d)], tree)


def _to_tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bf16 from jax
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree, dtype: torch.dtype | None = None,
                    device: torch.device | str = "cpu"):
    """The JAX package's params tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, container.init_params(seed))``) as the
    port's tree of tensors. A copy, not a transpose: both packages keep
    ``wq`` as (D, n_q, hd) and stacked layers on a leading axis."""
    def leaf(a):
        t = _to_tensor(a)
        if dtype is not None:
            t = t.to(dtype)
        return t.to(device)
    return tree_map(leaf, tree)


def count_params(tree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(tree))
