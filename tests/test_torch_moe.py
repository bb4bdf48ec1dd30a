"""The port's Mixture-of-Experts against the JAX package, on the CPU.

* ``_router``, ``capacity`` and ``moe_forward`` on numpy inputs from a
  seed, float32: y within 1e-5 (sums in other orders), aux within 1e-6;
  the routing (``idx``, and ``pos`` and ``keep`` from the token-major
  cumsum) identical, also at a capacity that drops assignments;
* ties: equal router logits pick the lower expert indices first, as
  ``jax.lax.top_k`` does;
* moonshot-v1-16b-a3b-smoke (first layer dense, 4 experts, top 2, one
  shared expert) and llama4-scout-17b-a16e-smoke (every layer MoE, top 1):
  prefill logits within 1e-4 and aux within 1e-6, 8 greedy decode steps
  contiguous and paged with identical tokens, and the 12-request Pod
  trace with identical tokens across the packages (tests/torch_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.configs import get_config as j_get_config
from repro.models import moe as j_moe
from repro.models import params as j_params
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.params import params_from_jax

pytestmark = pytest.mark.orchestrator

ARCHS = ("moonshot-v1-16b-a3b-smoke", "llama4-scout-17b-a16e-smoke")
Y_TOL = 1e-5
AUX_TOL = 1e-6


def _cfgs(arch="moonshot-v1-16b-a3b-smoke", **over):
    j, t = j_get_config(arch), get_config(arch)
    if over:
        j, t = j.with_overrides(**over), t.with_overrides(**over)
    return j, t


def _params(jcfg, seed=0):
    jp = j_params.materialize(j_moe.moe_defs(jcfg), jax.random.key(seed))
    np_p = jax.tree.map(np.asarray, jp)
    return jp, params_from_jax(np_p)


def _j_positions(idx, E, C):
    """The reference's position-in-expert lines (repro/models/moe.py:80-85)
    on its own idx."""
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(pos), np.asarray(pos < C)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("T", [1, 8, 13, 64, 512, 4096])
def test_capacity_matches(T):
    for arch in ARCHS + ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"):
        jcfg, tcfg = _cfgs(arch)
        assert moe.capacity(tcfg, T) == j_moe.capacity(jcfg, T)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tparams = _params(jcfg)
    x = _x((40, jcfg.d_model))
    ji, jw, jaux = j_moe._router(jp, jnp.asarray(x), jcfg)
    ti, tw, taux = moe._router(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    tp.close(jw, tw, Y_TOL)
    assert abs(float(jaux) - float(taux)) <= AUX_TOL


@pytest.mark.parametrize("arch,over,shape", [
    ("moonshot-v1-16b-a3b-smoke", {}, (2, 12)),
    ("llama4-scout-17b-a16e-smoke", {}, (3, 7)),
    # capacity 8 for 64 tokens x 2 choices over 4 experts: drops
    ("moonshot-v1-16b-a3b-smoke", {"capacity_factor": 0.25}, (4, 16)),
], ids=["moonshot", "llama4-scout", "drops"])
def test_moe_forward_and_routing_match(arch, over, shape):
    jcfg, tcfg = _cfgs(arch, **over)
    jp, tparams = _params(jcfg)
    x = _x((*shape, jcfg.d_model), seed=2)
    jy, jaux = j_moe.moe_forward(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_forward(tparams, torch.from_numpy(x), tcfg)
    tp.close(jy, ty, Y_TOL)
    assert abs(float(jaux) - float(taux)) <= AUX_TOL

    T = shape[0] * shape[1]
    C = moe.capacity(tcfg, T)
    xt = x.reshape(T, -1)
    ji, _, _ = j_moe._router(jp, jnp.asarray(xt), jcfg)
    ti, _, _ = moe._router(tparams, torch.from_numpy(xt), tcfg)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    jpos, jkeep = _j_positions(ji, jcfg.n_experts, C)
    tpos, tkeep, slot = moe.dispatch_positions(ti, tcfg.n_experts, C)
    np.testing.assert_array_equal(jpos, tpos.numpy())
    np.testing.assert_array_equal(jkeep, tkeep.numpy())
    assert slot.unique().numel() >= int(tkeep.sum())
    if over:
        assert int((~tkeep).sum()) > 0          # the case drops assignments
    else:
        assert bool(tkeep.all())


@pytest.mark.parametrize("tied", [(0, 1, 2, 3), (1, 2, 3), (1, 3)])
def test_ties_pick_the_lower_expert_first(tied):
    """Router columns outside ``tied`` push their logits below 0, the tied
    ones are zero: every token's logits tie exactly among ``tied``, and
    both packages pick its lowest indices (jax.lax.top_k's order)."""
    jcfg, tcfg = _cfgs()
    jp, tparams = _params(jcfg)
    E, D = jcfg.n_experts, jcfg.d_model
    router = np.zeros((D, E), np.float32)
    for e in range(E):
        if e not in tied:
            router[:, e] = -1.0
    x = np.abs(_x((16, D), seed=3)) + 0.1      # positive: -1 columns < 0
    jp = dict(jp, router=jnp.asarray(router))
    tparams = dict(tparams, router=torch.from_numpy(router))
    ji, jw, _ = j_moe._router(jp, jnp.asarray(x), jcfg)
    ti, tw, _ = moe._router(tparams, torch.from_numpy(x), tcfg)
    want = np.tile(np.array(tied[:tcfg.top_k]), (16, 1))
    np.testing.assert_array_equal(np.asarray(ji), want)
    np.testing.assert_array_equal(ti.numpy(), want)
    tp.close(jw, tw, Y_TOL)


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stevedore")
    return {arch: tp.make_env(root / arch, arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_aux_match(envs, arch):
    aux = tp.check_prefill(envs[arch])
    assert aux > 0                              # the MoE blocks' loss


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_contiguous(envs, arch):
    tp.check_greedy_contiguous(envs[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_paged(envs, arch):
    tp.check_greedy_paged(envs[arch])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("paged,prefix_cache", [(False, False), (True, True)],
                         ids=["contiguous", "paged+prefix"])
def test_pod_trace_tokens_identical_across_packages(envs, arch, paged,
                                                    prefix_cache):
    tp.check_pod_trace(envs[arch], paged, prefix_cache)


def test_sliced_draw_keeps_the_leaf_and_its_law(monkeypatch):
    """materialize draws a stacked leaf one layer at a time into the
    target dtype: the leaf's shape and dtype, std within 5% of
    scale / sqrt(fan_in) (truncated at 2 std: x 0.8796), fan_in from the
    WHOLE leaf's shape (the reference's formula), and no float32 draw
    larger than one layer."""
    from repro_torch.models import params as P
    draws = []
    real = P._draw

    def spy(d, shape, gen, device):
        draws.append(tuple(shape))
        return real(d, shape, gen, device)

    monkeypatch.setattr(P, "_draw", spy)
    leaf = P.stack_defs({"w": P.ParamDef((6, 64, 96), ("experts", "embed",
                                                       "mlp"))}, 5)
    out = P.materialize(leaf, 0, torch.bfloat16)["w"]
    assert tuple(out.shape) == (5, 6, 64, 96) and out.dtype == torch.bfloat16
    assert draws == [(6, 64, 96)] * 5
    std = 1.0 / np.sqrt(5 * 6 * 64)
    got = float(out.float().std())
    assert abs(got - 0.8796 * std) <= 0.05 * 0.8796 * std, (got, std)
    assert float(out.float().abs().max()) <= 2 * std * (1 + 2 ** -7)
    # an unstacked leaf is one draw of its own shape
    draws.clear()
    P.materialize({"e": P.ParamDef((32, 8), ("vocab", "embed"),
                                   "small_normal")}, 0)
    assert draws == [(32, 8)]
