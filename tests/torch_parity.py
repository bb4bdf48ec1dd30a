"""Shared checks of the port against the JAX package on the CPU, for the
parity files (test_torch_serving.py, test_torch_stablelm.py,
test_torch_moe.py, test_torch_frontend.py, test_torch_archs.py): both
packages build one image in float32, the JAX package's weights go to the
port as numpy, and

* prefill logits agree within LOGIT_TOL (1e-4: two libraries, sums in
  other orders), aux within AUX_TOL;
* 8 greedy decode steps, contiguous and paged (a shuffled page table):
  identical tokens, logits within LOGIT_TOL at every step;
* Pod + ContinuousScheduler on a 12-request trace (every third request
  declares a shared prefix): identical per-request tokens and tick
  counters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.runtime import Runtime as JRuntime
from repro.orchestrator import ContinuousScheduler as JScheduler
from repro.orchestrator import GenRequest as JRequest
from repro.orchestrator import Pod as JPod
from repro.orchestrator.scheduler import _insert_pages as j_insert_pages
from repro.serve.serve_step import ServeStepBuilder as JBuilder
from repro_torch.core.runtime import Runtime
from repro_torch.orchestrator import ContinuousScheduler, GenRequest, Pod
from repro_torch.orchestrator.scheduler import _insert_pages
from repro_torch.serve.serve_step import ServeStepBuilder

IMAGEFILE = """
FROM scratch
ARCH {arch}
SHAPE decode_32k seq_len=64 global_batch=4
MESH local
PRECISION compute=float32 params=float32
COLLECTIVES generic
"""

LOGIT_TOL = 1e-4
AUX_TOL = 1e-6


def make_env(root, arch: str) -> dict:
    jrt = JRuntime(root / "jax")
    jrt.build(IMAGEFILE.format(arch=arch), tag="stable")
    trt = Runtime(root / "torch")
    trt.build(IMAGEFILE.format(arch=arch), tag="stable")
    jc = jrt.run("stable")
    tc = trt.run("stable", platform="cpu")
    jparams = jc.init_params(0)
    np_params = jax.tree.map(np.asarray, jparams)
    return dict(jrt=jrt, trt=trt, jc=jc, tc=tc, jparams=jparams,
                np_params=np_params, tparams=tc.load_params(np_params))


def close(j, t, tol=LOGIT_TOL) -> float:
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    assert j.shape == t.shape, (j.shape, t.shape)
    err = float(np.abs(j - t).max())
    assert err <= tol, err
    return err


def greedy(x) -> np.ndarray:
    return np.asarray(x).argmax(-1).astype(np.int32)


def check_prefill(env, B: int = 2, S: int = 24, seed: int = 0):
    """Prefill logits within LOGIT_TOL and aux within AUX_TOL."""
    toks = np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)
    jl, jaux = env["jc"].model.forward(env["jparams"], jnp.asarray(toks))
    tl, taux = env["tc"].model.forward(env["tparams"],
                                       torch.from_numpy(toks).long())
    close(jl, tl)
    assert abs(float(jaux) - float(taux)) <= AUX_TOL, (float(jaux),
                                                       float(taux))
    return float(taux)


def check_greedy_contiguous(env, steps: int = 8):
    """Prefill a 12-token prompt into a 32-position slab, then ``steps``
    decode steps at per-row positions: the same tokens and logits."""
    rng = np.random.default_rng(1)
    B, P, L = 2, 12, 32
    toks = rng.integers(0, 256, (B, P)).astype(np.int32)
    jm, tm = env["jc"].model, env["tc"].model
    j_decode = jax.jit(jm.decode_step)
    jlog, jcache, _ = jm.forward(env["jparams"], jnp.asarray(toks),
                                 collect_cache=True, cache_len=L)
    tlog, tcache, _ = tm.forward(env["tparams"], torch.from_numpy(toks).long(),
                                 collect_cache=True, cache_len=L)
    close(jlog, tlog)
    jt, tt = greedy(jlog[:, -1]), greedy(tlog[:, -1].numpy())
    assert (jt == tt).all()
    for step in range(steps):
        pos = np.full((B,), P + step, np.int32)
        jlog, jcache = j_decode(env["jparams"], jcache,
                                jnp.asarray(jt[:, None]), jnp.asarray(pos))
        tlog, tcache = tm.decode_step(env["tparams"], tcache,
                                      torch.from_numpy(tt[:, None]).long(),
                                      torch.from_numpy(pos))
        close(jlog, tlog)
        jt, tt = greedy(jlog[:, -1]), greedy(tlog[:, -1].numpy())
        assert (jt == tt).all(), step


def check_greedy_paged(env, steps: int = 8):
    """Two slots of different prompt lengths prefill page-major into a
    shuffled pool (each package's scatter helper), then ``steps`` paged
    decode steps: the same tokens and logits."""
    ps = 8
    table = np.array([[3, 1, 6, 0], [5, 2, 7, 4]], np.int32)
    lens = [11, 6]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in lens]
    jpool = env["jc"].init_paged_cache(8, ps)
    tpool = env["tc"].init_paged_cache(8, ps)
    jpre = JBuilder(env["jc"].model, env["jc"].mesh,
                    env["jc"].rules).build_prefill_slot_paged(16, ps)
    tpre = ServeStepBuilder(env["tc"].model).build_prefill_slot_paged(16, ps)
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
    for step in range(steps):
        jlog, jpool = j_decode(
            env["jparams"], jpool, jnp.asarray(jt[:, None]), jnp.asarray(pos),
            page_table=jnp.asarray(table))
        tlog, tpool = env["tc"].model.decode_step(
            env["tparams"], tpool, torch.from_numpy(tt[:, None]).long(),
            torch.from_numpy(pos), page_table=torch.from_numpy(table))
        close(jlog, tlog)
        jt, tt = greedy(jlog[:, -1]), greedy(tlog[:, -1].numpy())
        assert (jt == tt).all(), step
        pos = pos + 1


def pod_trace(Req, n: int = 12, seed: int = 1, shared_len: int = 20):
    """Every third request shares a declared 20-token prefix."""
    rng = np.random.default_rng(seed)
    shared = np.random.default_rng(99).integers(0, 256, shared_len)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, 256, int(rng.integers(3, 20)))
        if i % 3 == 0:
            reqs.append(Req(rid=i, prompt=np.concatenate([shared, tail]),
                            max_new_tokens=int(rng.integers(2, 9)),
                            prefix_len=shared_len))
        else:
            reqs.append(Req(rid=i, prompt=tail,
                            max_new_tokens=int(rng.integers(2, 9))))
    return reqs


def check_pod_trace(env, paged: bool, prefix_cache: bool):
    """The 12-request trace through both packages' Pod: identical
    per-request tokens, prefill positions, decode ticks and prefix hits.
    Returns the two pods (JAX, port)."""
    kw = dict(replicas=1, n_slots=3, max_len=64, paged=paged, page_size=8,
              prefix_cache=prefix_cache)
    jp = JPod(env["jrt"], "stable", **kw)
    jreqs = pod_trace(JRequest)
    js = JScheduler(jp)
    js.submit(jreqs)
    js.run()
    tp = Pod(env["trt"], "stable", platform="cpu", params=env["np_params"],
             **kw)
    treqs = pod_trace(GenRequest)
    ts = ContinuousScheduler(tp)
    ts.submit(treqs)
    ts.run()
    assert all(r.state == "done" for r in treqs)
    assert [list(r.tokens) for r in jreqs] == [list(r.tokens) for r in treqs]
    je, te = jp.engines[0], tp.engines[0]
    assert te.prefill_positions == je.prefill_positions
    assert te.decode_ticks == je.decode_ticks
    assert te.prefix_hits == je.prefix_hits
    if prefix_cache:
        assert te.prefix_hits >= 1
        te.pool.check()
    return jp, tp
