"""The port's serving slice against the JAX package, on the CPU, on
llama3.2-3b-smoke with the JAX package's weights handed over as numpy.

* prefill logits within 1e-4 (f32, 2 layers, sums in different orders);
* 8 greedy decode steps, contiguous and paged: identical tokens, logits
  within 1e-4;
* suffix prefill over prefix pages (mid-page boundary) equals a full
  prefill;
* Pod + ContinuousScheduler on one 12-request trace: identical per-request
  tokens across the packages, contiguous and paged, prefix cache on and
  off. Greedy tokens are compared for equality; ties would decide tokens,
  so logits are compared with a tolerance where they are reachable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
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

pytestmark = pytest.mark.orchestrator

IMAGEFILE = """
FROM scratch
ARCH llama3.2-3b-smoke
SHAPE decode_32k seq_len=64 global_batch=4
MESH local
PRECISION compute=float32 params=float32
COLLECTIVES generic
"""

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("stevedore")
    jrt = JRuntime(root / "jax")
    jrt.build(IMAGEFILE, tag="stable")
    trt = Runtime(root / "torch")
    trt.build(IMAGEFILE, tag="stable")
    jc = jrt.run("stable")
    tc = trt.run("stable", platform="cpu")
    jparams = jc.init_params(0)
    np_params = jax.tree.map(np.asarray, jparams)
    return dict(jrt=jrt, trt=trt, jc=jc, tc=tc, jparams=jparams,
                np_params=np_params, tparams=tc.load_params(np_params))


def _close(j, t, tol=LOGIT_TOL):
    err = float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())
    assert err <= tol, err


def test_load_params_is_exact(env):
    flat_j = jax.tree.leaves(env["np_params"])
    from repro_torch.models.params import tree_leaves
    flat_t = tree_leaves(env["tparams"])
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b.numpy())


def test_prefill_logits_match(env):
    tp.check_prefill(env)


def test_greedy_decode_contiguous(env):
    """Prefill a 12-token prompt into a 32-position slab, then 8 decode
    steps at per-row positions: the same tokens and logits."""
    tp.check_greedy_contiguous(env)


def test_greedy_decode_paged(env):
    """Two slots of different prompt lengths prefill page-major into a
    shuffled page pool (through each package's scatter helper), then 8
    paged decode steps: the same tokens and logits."""
    tp.check_greedy_paged(env)


def test_suffix_prefill_equals_full_prefill(env):
    """A 30-token prompt whose first 20 tokens (2.5 pages of 8) sit in the
    pool: the suffix prefill's first token and page-major cache equal the
    full prefill's, in both packages."""
    ps, P, L = 8, 30, 20
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, P).astype(np.int32)
    tb = ServeStepBuilder(env["tc"].model)
    jb = JBuilder(env["jc"].model, env["jc"].mesh, env["jc"].rules)
    tpool = env["tc"].init_paged_cache(9, ps)
    jpool = env["jc"].init_paged_cache(9, ps)
    full_rows = np.array([1, 2, 3, 4], np.int32)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :P] = prompt
    ft, small_full = tb.build_prefill_slot_paged(32, ps)(
        env["tparams"], torch.from_numpy(toks).long(), P)
    fj, small_full_j = jb.build_prefill_slot_paged(32, ps)(
        env["jparams"], jnp.asarray(toks), jnp.int32(P))
    tpool = _insert_pages(tpool, small_full, torch.from_numpy(full_rows))
    jpool = j_insert_pages(jpool, small_full_j, jnp.asarray(full_rows))
    sfx = np.zeros((1, 16), np.int32)
    sfx[0, :P - L] = prompt[L:]
    prefix_pages = full_rows[:3]                    # ceil(20 / 8) pages
    st, small_sfx = tb.build_prefill_slot_paged(16, ps, prefix_len=L)(
        env["tparams"], tpool, torch.from_numpy(sfx).long(), P - L,
        torch.from_numpy(prefix_pages))
    sj, small_sfx_j = jb.build_prefill_slot_paged(16, ps, prefix_len=L)(
        env["jparams"], jpool, jnp.asarray(sfx), jnp.int32(P - L),
        jnp.asarray(prefix_pages))
    assert int(st[0]) == int(ft[0]) == int(sj[0]) == int(fj[0])
    # the suffix cache starts at the boundary page (front-partial merge of
    # its first L % ps positions) and equals the full prefill's pages 2..
    e_s = small_sfx["stage0"]["b0"]["k"]
    e_f = small_full["stage0"]["b0"]["k"]
    n_real = P - (L // ps) * ps                     # positions 16..29
    got = e_s.reshape(*e_s.shape[:2], -1, e_s.shape[-1])[:, :, :n_real]
    want = e_f[:, :, L // ps:].reshape(*e_f.shape[:2], -1,
                                       e_f.shape[-1])[:, :, :n_real]
    assert float((got - want).abs().max()) < LOGIT_TOL
    _close(small_sfx_j["stage0"]["b0"]["k"], e_s)


@pytest.mark.parametrize("paged,prefix_cache", [(False, False), (True, False),
                                                (True, True)],
                         ids=["contiguous", "paged", "paged+prefix"])
def test_pod_trace_tokens_identical_across_packages(env, paged, prefix_cache):
    jp, tp_ = tp.check_pod_trace(env, paged, prefix_cache)
    # tick-clocked completion metrics match field for field
    assert tp_.metrics.snapshot()["histograms"] == \
        jp.metrics.snapshot()["histograms"]
    te = tp_.engines[0]
    assert te.container.device == torch.device("cpu")
    assert sorted(te.free) == list(range(te.n_slots))


def test_spill_payload_is_a_copy_and_restores(env):
    """The spill tier's device side: a saved page is a COPY (the pool keeps
    changing in place after the save), and a load writes it back into any
    page, every layer and kv head."""
    pod = Pod(env["trt"], "stable", replicas=1, n_slots=2, max_len=32,
              paged=True, page_size=8, prefix_cache=True, spill_pages=None,
              platform="cpu", params=env["np_params"])
    eng = pod.engines[0]
    pool_k = eng.cache["stage0"]["b0"]["k"]   # (L, n_kv, n_pages, ps, hd)
    pool_v = eng.cache["stage0"]["b0"]["v"]
    pool_k[:, :, 3] = 1.5
    pool_v[:, :, 3] = -2.5
    payload = eng._spill_save(3)
    pool_k[:, :, 3] = -7.0
    assert torch.all(payload["stage0"]["b0"]["k"] == 1.5)
    eng._spill_load(5, payload)
    assert torch.all(pool_k[:, :, 5] == 1.5)
    assert torch.all(pool_v[:, :, 5] == -2.5)
    assert torch.all(pool_k[:, :, 3] == -7.0)


def _mixed_trace(Req):
    """Two long batch requests saturate a 2-slot paged engine; interactive
    arrivals can only admit by preempting one (page-level preemption, then
    a suffix re-prefill resume)."""
    def req(rid, gen, **kw):
        rng = np.random.default_rng(rid + 1)
        return Req(rid=rid, prompt=rng.integers(0, 256, 8),
                   max_new_tokens=gen, **kw)
    reqs = [req(0, 40, priority="batch"), req(1, 40, priority="batch")]
    for k, tick in enumerate((4, 8, 12)):
        reqs.append(req(2 + k, 3, arrival=tick))
    return reqs


def test_preemption_resume_tokens_identical_across_packages(env):
    span_pages = -(-(8 + 40 + 4) // 8)
    kw = dict(replicas=1, n_slots=2, max_len=64, paged=True, page_size=8,
              n_pages=2 * span_pages + 1, decode_chunk=4)
    jp = JPod(env["jrt"], "stable", **kw)
    js = JScheduler(jp)
    jreqs = _mixed_trace(JRequest)
    js.submit(jreqs)
    js.run(max_ticks=2000)
    tp = Pod(env["trt"], "stable", platform="cpu", params=env["np_params"],
             **kw)
    ts = ContinuousScheduler(tp)
    treqs = _mixed_trace(GenRequest)
    ts.submit(treqs)
    while ts.busy:
        ts.step()
        tp.engines[0].pool.check()      # pool invariants after every tick
        assert ts.tick < 2000
    te, je = tp.engines[0], jp.engines[0]
    assert te.preemptions >= 1 and te.preemptions == te.resumes
    assert (te.preemptions, te.resumes) == (je.preemptions, je.resumes)
    assert all(r.state == "done" for r in treqs)
    assert [list(r.tokens) for r in treqs] == [list(r.tokens) for r in jreqs]


# ---------------------------------------------------------------------------
# the JAX suite's slot-engine invariants, re-run on the port
# ---------------------------------------------------------------------------

def _tpod(env, **kw):
    return Pod(env["trt"], "stable", replicas=1, platform="cpu",
               params=env["np_params"], **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_port_decode_chunk1_matches_chunk4(env, paged):
    """The single-tick decode step (chunk=1) and the multi-step decode
    loop give identical tokens for one trace."""
    outs = []
    for chunk in (1, 4):
        pod = _tpod(env, n_slots=2, max_len=56, decode_chunk=chunk,
                    paged=paged, page_size=8)
        sched = ContinuousScheduler(pod)
        reqs = [GenRequest(rid=i, prompt=np.arange(1, 7) * (i + 1) % 250,
                           max_new_tokens=6) for i in range(3)]
        sched.submit(reqs)
        sched.run(max_ticks=1000)
        outs.append([r.tokens for r in reqs])
    assert outs[0] == outs[1]


def test_port_eos_frees_slot_early(env):
    """A request hitting EOS stops before its budget and frees its slot."""
    pod = _tpod(env, n_slots=2, max_len=56)
    eng = pod.engines[0]
    probe = GenRequest(rid=0, prompt=np.arange(5), max_new_tokens=8)
    sched = ContinuousScheduler(pod)
    sched.submit(probe)
    sched.run(max_ticks=100)
    eos = probe.tokens[2]
    hit = GenRequest(rid=1, prompt=np.arange(5), max_new_tokens=40,
                     eos_id=eos)
    sched.submit(hit)
    sched.run(max_ticks=1000)
    assert hit.finish_reason == "eos" and len(hit.tokens) < 40
    assert hit.tokens[-1] == eos
    assert sorted(eng.free) == list(range(eng.n_slots))


@pytest.mark.parametrize("paged,reason", [(False, "slot capacity"),
                                          (True, "page-table span")],
                         ids=["contiguous", "paged"])
def test_port_oversized_request_rejected_not_fatal(env, paged, reason):
    """An oversized request is rejected with the limit named; the request
    behind it still completes."""
    pod = _tpod(env, n_slots=1, max_len=32, paged=paged, page_size=8)
    sched = ContinuousScheduler(pod)
    bad = GenRequest(rid=0, prompt=np.arange(20), max_new_tokens=20)
    ok = GenRequest(rid=1, prompt=np.arange(6), max_new_tokens=4)
    sched.submit([bad, ok])
    sched.run(max_ticks=100)
    assert bad.state == "rejected" and reason in bad.error
    assert ok.state == "done" and len(ok.tokens) == 4
    assert sched.admission_order == [1]
