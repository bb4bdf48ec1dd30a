"""tests/test_consistency.py on the port, against the JAX package, on the
CPU: the whole-batch serve path (prefill, lockstep decode at one scalar
position, the greedy loop from a scalar start) must reproduce the full
forward (f32, all ten archs at their smoke sizes) and the JAX package's
numbers, and generation must be causal.

Weights: the JAX package's ``materialize`` from ``jax.random.key(0)``,
handed to the port as numpy; token inputs from numpy seeds. Tolerances:
decode against the forward < 1e-4 (the reference's own bound), port
against JAX logits and cache leaves within ``LOGIT_TOL`` (1e-4), greedy
tokens identical, causality < 1e-5 (the reference's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.configs import ARCH_IDS, get_config as j_get_config
from repro.dist.mesh import make_platform_mesh
from repro.dist.sharding import ShardingRules
from repro.models import params as JP
from repro.models.transformer import Model as JModel
from repro.serve.serve_step import ServeStepBuilder as JBuilder
from repro.serve.serve_step import greedy_sample as j_greedy_sample
from repro_torch.configs import get_config
from repro_torch.models import attention as attn_mod
from repro_torch.models.params import params_from_jax, tree_leaves
from repro_torch.models.transformer import Model
from repro_torch.serve.serve_step import ServeStepBuilder, greedy_sample

LOGIT_TOL = tp.LOGIT_TOL
GEN_ARCHS = ["llama3.2-3b", "mamba2-2.7b", "recurrentgemma-2b"]
_SETUPS: dict = {}


def _setup(arch):
    """Both packages' models of ``arch``'s smoke config (MoE made dropless,
    as the reference does) with the JAX package's key(0) weights."""
    if arch not in _SETUPS:
        jcfg = j_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        if cfg.n_experts:
            jcfg = jcfg.with_overrides(capacity_factor=float(jcfg.n_experts))
            cfg = cfg.with_overrides(capacity_factor=float(cfg.n_experts))
        jm = JModel(jcfg, tp=1, act_dtype=jnp.float32)
        jprm = JP.materialize(jm.param_defs(), jax.random.key(0))
        m = Model(cfg, tp=1, act_dtype=torch.float32)
        prm = params_from_jax(jax.tree.map(np.asarray, jprm))
        _SETUPS[arch] = (cfg, jm, jprm, m, prm)
    return _SETUPS[arch]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _fe(cfg, B):
    """The reference's constant frontend prefix (0.01), or None."""
    if not cfg.frontend:
        return None, None
    fe = np.full((B, cfg.frontend_len, cfg.d_model), 0.01, np.float32)
    return jnp.asarray(fe), torch.from_numpy(fe)


def _err(j, t) -> float:
    return float(np.abs(np.asarray(j, np.float32)
                        - t.detach().float().numpy()).max())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_forward_f32(arch):
    """Mirrors test_consistency.py::test_decode_matches_forward_f32: a
    24-token prefill then one decode step at a 0-d position equals the full
    forward's last row (< 1e-4), and equals the JAX package's
    ``decode_step`` at ``jnp.int32(S)`` within LOGIT_TOL."""
    cfg, jm, jprm, m, prm = _setup(arch)
    B, S = 2, 24
    toks = _tokens(cfg, (B, S + 1), 1)
    jfe, fe = _fe(cfg, B)
    F = cfg.frontend_len
    Stot = S + 1 + F
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        full, *_ = m.forward(prm, t, frontend_embeds=fe)
        _, cache, _ = m.forward(prm, t[:, :S], frontend_embeds=fe,
                                collect_cache=True, cache_len=Stot)
        got, _ = m.decode_step(prm, cache, t[:, S:S + 1],
                               torch.tensor(S + F, dtype=torch.int32))
    assert float((full[:, -1] - got[:, 0]).abs().max()) < 1e-4
    _, jcache, _ = jm.forward(jprm, jnp.asarray(toks[:, :S]),
                              frontend_embeds=jfe, collect_cache=True,
                              cache_len=Stot)
    jgot, _ = jm.decode_step(jprm, jcache, jnp.asarray(toks[:, S:S + 1]),
                             jnp.int32(S + F))
    assert _err(jgot, got) <= LOGIT_TOL


@pytest.mark.parametrize("arch", GEN_ARCHS)
def test_multi_step_generation_stable(arch):
    """Mirrors test_consistency.py::test_multi_step_generation_stable:
    ``build_prefill`` then ``build_generate_loop(8)`` from the scalar start
    S gives (B, 8) tokens in the canonical vocab, identical to the JAX
    package's, with last logits and every cache leaf within LOGIT_TOL."""
    cfg, jm, jprm, m, prm = _setup(arch)
    B, S, n_new = 2, 16, 8
    toks = _tokens(cfg, (B, S), 1)
    jb = JBuilder(jm, make_platform_mesh("local"), ShardingRules.default())
    jlast, jcache = jb.build_prefill(cache_len=S + n_new + 1)(
        jprm, jnp.asarray(toks))
    jfirst = j_greedy_sample(jlast, cfg.vocab_size)[:, None]
    jout, _ = jb.build_generate_loop(n_new)(jprm, jcache, jfirst,
                                            jnp.int32(S))
    b = ServeStepBuilder(m)
    with torch.no_grad():
        last, cache = b.build_prefill(cache_len=S + n_new + 1)(
            prm, torch.from_numpy(toks).long())
        assert _err(jlast, last) <= LOGIT_TOL
        for jl, tl in zip(jax.tree.leaves(jcache), tree_leaves(cache)):
            assert _err(jl, tl) <= LOGIT_TOL
        first = greedy_sample(last, cfg.vocab_size)[:, None]
        out, _ = b.build_generate_loop(n_new)(
            prm, cache, first, torch.tensor(S, dtype=torch.int32))
    assert tuple(out.shape) == (B, n_new)
    assert int(out.max()) < cfg.vocab_size and int(out.min()) >= 0
    np.testing.assert_array_equal(np.asarray(jfirst), first.numpy())
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())


def test_forward_is_causal():
    """Mirrors test_consistency.py::test_forward_is_causal: perturbing the
    last token leaves every earlier logit within 1e-5 (rec + local
    attention, ssm, full attention)."""
    for arch in ["recurrentgemma-2b", "mamba2-2.7b", "llama3.2-3b"]:
        cfg, _, _, m, prm = _setup(arch)
        toks = _tokens(cfg, (1, 24), 1)
        toks2 = toks.copy()
        toks2[:, -1] = (toks[:, -1] + 7) % cfg.vocab_size
        with torch.no_grad():
            l1, _ = m.forward(prm, torch.from_numpy(toks).long())
            l2, _ = m.forward(prm, torch.from_numpy(toks2).long())
        assert float((l1[:, :-1] - l2[:, :-1]).abs().max()) < 1e-5, arch


def test_padded_vocab_never_sampled():
    """Mirrors test_consistency.py::test_padded_vocab_never_sampled:
    internvl2's vocab 92553 pads to 92672; padded columns at 100 are never
    sampled, and the sample equals the JAX package's."""
    cfg = get_config("internvl2-2b").reduced()
    logits = np.zeros((4, 92672), np.float32)
    logits[:, 92553:] = 100.0
    logits[1, 17] = 1.0
    s = greedy_sample(torch.from_numpy(logits), cfg.vocab_size)
    assert int(s.max()) < cfg.vocab_size
    js = j_greedy_sample(jnp.asarray(logits), cfg.vocab_size)
    np.testing.assert_array_equal(np.asarray(js), s.numpy())


@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-2b",
                                  "internvl2-2b"])
def test_prefill_positions_are_canonical_rows(arch, monkeypatch):
    """On the card ``attend``'s flash route takes only the canonical (1, S)
    position rows; the whole-batch prefill (a frontend prefix included)
    must build them in that shape, which the CPU cannot show by raising, so
    every ``attend`` call of the prefill is recorded here."""
    cfg, _, _, m, prm = _setup(arch)
    B, S = 3, 16
    _, fe = _fe(cfg, B)
    seen = []
    real = attn_mod.attend

    def spy(q, k, v, q_pos, k_pos, *a, **kw):
        seen.append((q.shape[1], k.shape[1], tuple(q_pos.shape),
                     tuple(k_pos.shape), kw.get("q_offset", 0)))
        return real(q, k, v, q_pos, k_pos, *a, **kw)

    monkeypatch.setattr(attn_mod, "attend", spy)
    with torch.no_grad():
        ServeStepBuilder(m).build_prefill(64)(
            prm, torch.from_numpy(_tokens(cfg, (B, S), 2)).long(), fe)
    rows = S + cfg.frontend_len
    assert seen and all(s == (rows, rows, (1, rows), (1, rows), 0)
                        for s in seen), seen


@pytest.mark.parametrize("arch", [a + "-smoke" for a in ARCH_IDS])
def test_container_whole_batch_matches_jax(arch, tmp_path):
    """``Container.prefill_fn()`` (the cell's 64 positions), one
    ``decode_fn()`` step at a 0-d position, then the ``generate`` step from
    a scalar start, in both packages' containers (float32 image; frontend
    archs with a seeded (B, F, D) prefix): last logits, every cache leaf
    and the decode logits within LOGIT_TOL, greedy tokens identical."""
    env = tp.make_env(tmp_path, arch)
    jc, tc = env["jc"], env["tc"]
    cfg = tc.arch
    B, S, G = 2, 16, 4
    F = cfg.frontend_len if cfg.frontend else 0
    toks = _tokens(cfg, (B, S), 3)
    jfe = fe = None
    if F:
        arr = 0.02 * np.random.default_rng(4).standard_normal(
            (B, F, cfg.d_model)).astype(np.float32)
        jfe, fe = jnp.asarray(arr), torch.from_numpy(arr)
    jlast, jcache = jc.prefill_fn()(env["jparams"], jnp.asarray(toks), jfe)
    last, cache = tc.prefill_fn()(env["tparams"],
                                  torch.from_numpy(toks).long(), fe)
    assert not last.requires_grad
    assert _err(jlast, last) <= LOGIT_TOL
    jleaves, leaves = jax.tree.leaves(jcache), tree_leaves(cache)
    assert [tuple(a.shape) for a in jleaves] == \
        [tuple(t.shape) for t in leaves]
    for jl, tl in zip(jleaves, leaves):
        assert _err(jl, tl) <= LOGIT_TOL
    jt = j_greedy_sample(jlast, cfg.vocab_size)[:, None]
    tt = greedy_sample(last, cfg.vocab_size)[:, None]
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())

    jlog, jcache = jc.decode_fn()(env["jparams"], jcache, jt,
                                  jnp.int32(S + F))
    log, cache = tc.decode_fn()(env["tparams"], cache, tt,
                                torch.tensor(S + F, dtype=torch.int32))
    assert _err(jlog, log) <= LOGIT_TOL
    jt = j_greedy_sample(jlog, cfg.vocab_size)[:, None]
    tt = greedy_sample(log, cfg.vocab_size)[:, None]
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())

    jgen = JBuilder(jc.model, jc.mesh, jc.rules).build_generate_loop(G)
    jout, _ = jgen(env["jparams"], jcache, jt, jnp.int32(S + F + 1))
    gen = tc.compile_serve_step("generate", batch=B, cache_len=64,
                                gen_steps=G)
    out, _ = gen(env["tparams"], cache, tt, S + F + 1)
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())


def test_build_serve_step_prefill_counts_like_jax(tmp_path):
    """``compile_serve_step("prefill", ...)`` builds the whole-batch
    prefill through the CompileCache under the ``prefill`` dispatch class
    (``lower_serve_step("prefill")``'s counterpart): a miss, then a hit,
    in both packages, and the built step equals ``prefill_fn``'s."""
    env = tp.make_env(tmp_path, "llama3.2-3b-smoke")
    jc, tc = env["jc"], env["tc"]
    shapes = dict(batch=2, prompt_len=16, cache_len=32)
    for c in (jc, tc):
        for _ in range(2):
            c.compile_serve_step("prefill", **shapes)
    stats = {c: {k: (v["hits"], v["misses"])
                 for k, v in c.serve_compile_stats.items()}
             for c in (jc, tc)}
    assert stats[tc] == stats[jc] == {"prefill": (1, 1)}
    toks = torch.from_numpy(_tokens(tc.arch, (2, 16), 5)).long()
    last, cache = tc.compile_serve_step("prefill", **shapes)(
        env["tparams"], toks)
    last2, cache2 = tc.prefill_fn(32)(env["tparams"], toks)
    assert torch.equal(last, last2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache),
                                                  tree_leaves(cache2)))
    jlast, _ = jc.compile_serve_step("prefill", **shapes)(
        env["jparams"], jnp.asarray(toks.numpy().astype(np.int32)))
    assert _err(jlast, last) <= LOGIT_TOL
