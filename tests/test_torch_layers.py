"""The PyTorch port's configs, images, params and layers against the JAX
package, on the CPU.

Inputs come from numpy seeds and go to both packages. Tolerance for f32
layer outputs: 1e-5 absolute (two libraries, same f32 arithmetic, sums in
different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.core.imagefile import parse_imagefile
from repro.models import layers as jl
from repro.models.transformer import Model as JModel
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.imagefile import parse_imagefile as t_parse_imagefile
from repro_torch.models import layers as tl
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.params import (ParamDef, count_params, materialize,
                                       params_from_jax, stack_defs,
                                       tree_leaves)
from repro_torch.models.transformer import Model as TModel

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(j, t, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert j.shape == t.shape, (j.shape, t.shape)
    err = float(np.abs(j - t).max()) if j.size else 0.0
    assert err <= tol, err


# ---------------------------------------------------------------------------
# configs and images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a + s for a in ARCH_IDS for s in ("", "-smoke")])
def test_get_config_fields_equal(arch):
    assert ARCH_IDS == T_ARCH_IDS
    j, t = get_config(arch), t_get_config(arch)
    assert isinstance(t, TModelConfig)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.layer_types() == t.layer_types()
    assert j.param_count() == t.param_count()


IMAGEFILE = """
FROM scratch
ARCH llama3.2-3b
SHAPE decode_32k seq_len=1024 global_batch=8
MESH local
PRECISION compute=bfloat16 params=bfloat16
COLLECTIVES generic
SET decode_chunk=4
LABEL slice=1
"""


def test_imagefile_digest_equal():
    j, t = parse_imagefile(IMAGEFILE), t_parse_imagefile(IMAGEFILE)
    assert j.digest == t.digest
    assert j.config() == t.config()


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def test_param_defs_match_jax_tree():
    """Same leaves, shapes and init laws as the JAX package's tree."""
    cfg = get_config("llama3.2-3b-smoke")
    jd = JModel(cfg).param_defs()
    td = TModel(t_get_config("llama3.2-3b-smoke")).param_defs()
    jl_ = jax.tree.leaves_with_path(jd, is_leaf=lambda x: hasattr(x, "init"))
    tl_ = tree_leaves(td)
    assert len(jl_) == len(tl_)
    for (_, a), b in zip(jl_, tl_):
        assert (a.shape, a.logical, a.init, a.scale) == \
            (b.shape, b.logical, b.init, b.scale)
    assert count_params(td) == sum(int(np.prod(a.shape)) for _, a in jl_)


def test_materialize_distributions():
    """Seeded, device-explicit init that follows the JAX laws: zeros/ones
    exact, fan_in truncated at 2 std with std 1/sqrt(fan_in)."""
    defs = stack_defs({"w": ParamDef((256, 64), ("embed", "mlp")),
                       "s": ParamDef((64,), ("embed",), "ones"),
                       "e": ParamDef((512, 64), ("vocab", "embed"),
                                     "small_normal")}, 2)
    a = materialize(defs, 3)
    b = materialize(defs, 3)
    c = materialize(defs, 4)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not torch.equal(a["w"], c["w"])
    std = 1 / np.sqrt(2 * 256)
    assert float(a["w"].abs().max()) <= 2 * std + 1e-7
    assert abs(float(a["w"].std()) - std * 0.88) < 0.1 * std   # trunc at 2σ
    assert torch.equal(a["s"], torch.ones(2, 64))
    assert abs(float(a["e"].std()) - 0.02) < 0.002
    assert materialize(defs, 0, torch.bfloat16)["w"].dtype == torch.bfloat16


def test_params_from_jax_is_a_copy():
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(1, 2, 3)},
            "b": jnp.ones((2,), jnp.bfloat16)}
    tree = jax.tree.map(np.asarray, tree)
    out = params_from_jax(tree)
    assert out["a"]["w"].shape == (1, 2, 3)
    np.testing.assert_array_equal(out["a"]["w"].numpy(), tree["a"]["w"])
    assert out["b"].dtype == torch.bfloat16 and float(out["b"].sum()) == 2.0
    tree["a"]["w"][0, 0, 0] = 99.0
    assert float(out["a"]["w"][0, 0, 0]) == 0.0


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    j = jl.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), kind)
    t = tl.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    _close(j, t)


def test_apply_norm_bf16_upcasts():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    j = jl.apply_norm({"scale": jnp.asarray(s)},
                      jnp.asarray(x, jnp.bfloat16), "rmsnorm")
    t = tl.apply_norm({"scale": _t(s)}, _t(x).to(torch.bfloat16), "rmsnorm")
    assert t.dtype == torch.bfloat16
    _close(j.astype(jnp.float32), t, tol=1e-2)


@pytest.mark.parametrize("pct,theta", [(1.0, 500_000.0), (0.25, 10_000.0),
                                       (0.5, 10_000.0)])
def test_apply_rope(pct, theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 3000, (2, 7))).astype(np.int32)
    _close(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, pct),
           tl.apply_rope(_t(x), _t(pos), theta, pct), tol=1e-4)


def test_apply_rope_interleaved_pairs():
    """Pairs are (x[2i], x[2i+1]), not the rotate-half halves."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0
    out = tl.apply_rope(x, torch.tensor([[1]]), 10_000.0)
    assert abs(float(out[..., 1]) - np.sin(1.0)) < 1e-6
    assert float(out[..., 2]) == 0.0


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_apply_mlp(kind):
    rng = np.random.default_rng(4)
    D, F = 32, 48
    x = rng.standard_normal((2, 3, D)).astype(np.float32)
    p = {k: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
         for k, shape in (("wg", (D, F)), ("wu", (D, F)), ("wi", (D, F)),
                          ("wd", (F, D)))}
    j = jl.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), kind)
    t = tl.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), kind)
    _close(j, t)


@pytest.mark.parametrize("v", [1, 128, 129, 256, 128_256, 256_000])
def test_padded_vocab(v):
    assert jl.padded_vocab(v) == tl.padded_vocab(v)


@pytest.mark.parametrize("embed_scale,tie", [(False, True), (True, False)])
def test_embed_and_logits(embed_scale, tie):
    cfg = dataclasses.replace(get_config("llama3.2-3b-smoke"),
                              embed_scale=embed_scale, tie_embeddings=tie)
    tcfg = dataclasses.replace(t_get_config("llama3.2-3b-smoke"),
                               embed_scale=embed_scale, tie_embeddings=tie)
    rng = np.random.default_rng(5)
    vp, D = jl.padded_vocab(cfg.vocab_size), cfg.d_model
    p = {"tokens": rng.standard_normal((vp, D)).astype(np.float32)}
    if not tie:
        p["head"] = rng.standard_normal((D, vp)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jx = jl.embed_tokens(jax.tree.map(jnp.asarray, p), jnp.asarray(toks), cfg,
                         jnp.float32)
    tx = tl.embed_tokens({k: _t(v) for k, v in p.items()},
                         _t(toks).long(), tcfg, torch.float32)
    _close(jx, tx)
    _close(jl.lm_logits(jax.tree.map(jnp.asarray, p), jx, cfg),
           tl.lm_logits({k: _t(v) for k, v in p.items()}, tx, tcfg), tol=1e-4)
