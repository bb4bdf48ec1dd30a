"""stablelm-3b's layout at head dim 80, the port against the JAX package on
the CPU, with the JAX package's weights handed over as numpy.

stablelm-3b (LayerNorm, partial rotary 25%, MHA 32 q / 32 kv heads of 80)
is cut in depth and width but keeps its head dim: 2 layers, 2 heads of 80,
d_model 160, d_ff 256, vocab 256 (``ModelConfig.reduced()`` would give hd
16, which every ``-smoke`` model has; the kernels' head-dim dispatch is
what this file's width is for). Both packages build it from an Imagefile's
ARCH overrides, which equal ``dataclasses.replace`` on their
``get_config("stablelm-3b")``.

* prefill logits within 1e-4 (float32; the packages sum in other orders);
* 8 greedy decode steps, contiguous and paged (a shuffled page table,
  pages of 8): identical tokens, logits within 1e-4 at every step.

On the CPU the port's attention runs its kernels' plain versions; the
kernels themselves at head dim 80 are held against those by
tests/test_torch_cuda.py and chip_smoke.py on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.runtime import Runtime as JRuntime
from repro.orchestrator.scheduler import _insert_pages as j_insert_pages
from repro.serve.serve_step import ServeStepBuilder as JBuilder
from repro_torch.configs import get_config
from repro_torch.core.runtime import Runtime
from repro_torch.models.params import tree_leaves
from repro_torch.orchestrator.scheduler import _insert_pages
from repro_torch.serve.serve_step import ServeStepBuilder

pytestmark = pytest.mark.orchestrator

CUT = dict(n_layers=2, d_model=160, n_heads=2, n_kv_heads=2, head_dim=80,
           d_ff=256, vocab_size=256)

IMAGEFILE = """
FROM scratch
ARCH stablelm-3b {overrides}
MESH local
PRECISION compute=float32 params=float32
""".format(overrides=" ".join(f"{k}={v}" for k, v in CUT.items()))

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("stevedore")
    jrt = JRuntime(root / "jax")
    jrt.build(IMAGEFILE, tag="stablelm")
    trt = Runtime(root / "torch")
    trt.build(IMAGEFILE, tag="stablelm")
    jc = jrt.run("stablelm")
    tc = trt.run("stablelm", platform="cpu")
    jparams = jc.init_params(0)
    np_params = jax.tree.map(np.asarray, jparams)
    return dict(jc=jc, tc=tc, jparams=jparams,
                tparams=tc.load_params(np_params))


def _close(j, t, tol=LOGIT_TOL):
    err = float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())
    assert err <= tol, err


def _greedy(x):
    return np.asarray(x).argmax(-1).astype(np.int32)


def test_config_is_stablelm_cut_at_head_dim_80(env):
    j_want = dataclasses.replace(j_get_config("stablelm-3b"), **CUT)
    t_want = dataclasses.replace(get_config("stablelm-3b"), **CUT)
    assert env["jc"].arch == j_want and env["tc"].arch == t_want
    a = env["tc"].arch
    assert (a.head_dim, a.n_heads, a.n_kv_heads, a.norm, a.rope_pct) == \
        (80, 2, 2, "layernorm", 0.25)
    assert dataclasses.asdict(a) == dataclasses.asdict(env["jc"].arch)


def test_prefill_logits_match(env):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 24)).astype(np.int32)
    jl, _ = env["jc"].model.forward(env["jparams"], jnp.asarray(toks))
    tl, _ = env["tc"].model.forward(env["tparams"],
                                    torch.from_numpy(toks).long())
    assert tl.shape == tuple(jl.shape)
    _close(jl, tl)


def test_greedy_decode_contiguous(env):
    """Prefill a 12-token prompt into a 32-position slab, then 8 decode
    steps at per-row positions: the same tokens and logits."""
    rng = np.random.default_rng(1)
    B, P, L = 2, 12, 32
    toks = rng.integers(0, 256, (B, P)).astype(np.int32)
    jm, tm = env["jc"].model, env["tc"].model
    j_decode = jax.jit(jm.decode_step)
    jlog, jcache, _ = jm.forward(env["jparams"], jnp.asarray(toks),
                                 collect_cache=True, cache_len=L)
    tlog, tcache, _ = tm.forward(env["tparams"], torch.from_numpy(toks).long(),
                                 collect_cache=True, cache_len=L)
    _close(jlog, tlog)
    jt = _greedy(jlog[:, -1])
    tt = _greedy(tlog[:, -1].numpy())
    assert (jt == tt).all()
    for step in range(8):
        pos = np.full((B,), P + step, np.int32)
        jlog, jcache = j_decode(env["jparams"], jcache,
                                jnp.asarray(jt[:, None]), jnp.asarray(pos))
        tlog, tcache = tm.decode_step(env["tparams"], tcache,
                                      torch.from_numpy(tt[:, None]).long(),
                                      torch.from_numpy(pos))
        _close(jlog, tlog)
        jt, tt = _greedy(jlog[:, -1]), _greedy(tlog[:, -1].numpy())
        assert (jt == tt).all(), step


def test_greedy_decode_paged(env):
    """Two slots of different prompt lengths prefill page-major into a
    shuffled pool of (n_kv, n_pages, 8, 80) pages (through each package's
    scatter helper), then 8 paged decode steps: the same tokens and
    logits."""
    ps = 8
    table = np.array([[3, 1, 6, 0], [5, 2, 7, 4]], np.int32)
    n_pages = 8
    lens = [11, 6]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in lens]
    jpool = env["jc"].init_paged_cache(n_pages, ps)
    tpool = env["tc"].init_paged_cache(n_pages, ps)
    assert {t.shape[-1] for t in tree_leaves(tpool)} == {80}
    jb = JBuilder(env["jc"].model, env["jc"].mesh, env["jc"].rules)
    tb = ServeStepBuilder(env["tc"].model)
    jpre, tpre = (jb.build_prefill_slot_paged(16, ps),
                  tb.build_prefill_slot_paged(16, ps))
    first_j, first_t = [], []
    for b, pr in enumerate(prompts):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(pr)] = pr
        fj, small_j = jpre(env["jparams"], jnp.asarray(toks),
                           jnp.int32(len(pr)))
        ft, small_t = tpre(env["tparams"], torch.from_numpy(toks).long(),
                           len(pr))
        jpool = j_insert_pages(jpool, small_j, jnp.asarray(table[b, :2]))
        tpool = _insert_pages(tpool, small_t, torch.from_numpy(table[b, :2]))
        first_j.append(int(fj[0]))
        first_t.append(int(ft[0]))
    assert first_j == first_t
    jt = np.array(first_j, np.int32)
    tt = jt.copy()
    pos = np.array(lens, np.int32)
    j_decode = jax.jit(env["jc"].model.decode_step)
    for step in range(8):
        jlog, jpool = j_decode(
            env["jparams"], jpool, jnp.asarray(jt[:, None]), jnp.asarray(pos),
            page_table=jnp.asarray(table))
        tlog, tpool = env["tc"].model.decode_step(
            env["tparams"], tpool, torch.from_numpy(tt[:, None]).long(),
            torch.from_numpy(pos), page_table=torch.from_numpy(table))
        _close(jlog, tlog)
        jt, tt = _greedy(jlog[:, -1]), _greedy(tlog[:, -1].numpy())
        assert (jt == tt).all(), step
        pos = pos + 1
