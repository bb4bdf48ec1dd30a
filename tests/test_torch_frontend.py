"""Frontend-embedding serving (musicgen-medium, internvl2-2b) on the port,
on the CPU, at their smoke sizes (a 4-row frontend buffer, d_model 64).

The invariants of tests/test_frontend_serving.py, re-run on
``repro_torch``: serving in both modes, continuous equals static on the
shared trace (contiguous and paged), the engine's prefill equals
``Model.forward``, partial and absent prefixes with paged parity, the
prefix conditions the output, the rejections, prefix cache on/off parity
and the span against ``max_len``.

Across the packages, with the JAX package's weights handed over as numpy
(float32): prefill logits of a packed [frontend, prompt] batch with
per-row frontend lengths within 1e-4, the first tokens of the slot
prefill identical, and identical per-request tokens on a Pod trace of
full, partial and absent prefixes, contiguous and paged.
"""

import io
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.orchestrator import ContinuousScheduler as JScheduler
from repro.orchestrator import GenRequest as JRequest
from repro.orchestrator import Pod as JPod
from repro.serve.serve_step import ServeStepBuilder as JBuilder
from repro_torch.core.runtime import Runtime
from repro_torch.launch.serve import serve_continuous, serve_static
from repro_torch.orchestrator import ContinuousScheduler, GenRequest, Pod
from repro_torch.serve.serve_step import ServeStepBuilder

pytestmark = pytest.mark.orchestrator

FRONTEND_ARCHS = ("musicgen-medium-smoke", "internvl2-2b-smoke")


@pytest.fixture(scope="module")
def rt(tmp_path_factory):
    rt = Runtime(tmp_path_factory.mktemp("stevedore"))
    for arch in FRONTEND_ARCHS + ("llama3.2-3b-smoke",):
        rt.build(tp.IMAGEFILE.format(arch=arch), tag=arch)
    return rt


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    return {arch: tp.make_env(root / arch, arch) for arch in FRONTEND_ARCHS}


def _pod(rt, arch, **kw):
    return Pod(rt, arch, replicas=1, platform="cpu", **kw)


def _frontend(rng, fe_len, d_model):
    return 0.02 * rng.standard_normal((fe_len, d_model)).astype(np.float32)


def _serve_args(**kw):
    args = SimpleNamespace(slots=3, prompt_len=8, gen=6, requests=7, seed=0,
                           platform="cpu", replicas=1, fairness_cap=4,
                           arrive_per_tick=8, paged=False, page_size=8)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_archs_serve_in_both_modes(rt, arch):
    pod = _pod(rt, arch, n_slots=2, max_len=40)              # no raise
    assert pod.engines[0].fe_len == 4
    with redirect_stdout(io.StringIO()):
        res = serve_static(rt, arch, _serve_args(requests=2))
    assert res["requests"] == 2
    assert all(len(t) >= 1 for t in res["request_tokens"].values())


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_continuous_matches_static_on_shared_trace(rt, arch):
    outs = {}
    with redirect_stdout(io.StringIO()):
        outs["continuous"] = serve_continuous(rt, arch, _serve_args())
        outs["static"] = serve_static(rt, arch, _serve_args())
        outs["paged"] = serve_continuous(rt, arch, _serve_args(paged=True))
    ref = outs["continuous"]["request_tokens"]
    assert len(ref) == 7
    assert outs["static"]["request_tokens"] == ref
    assert outs["paged"]["request_tokens"] == ref
    assert len({len(t) for t in ref.values()}) > 1


def test_prefill_matches_model_forward(rt):
    pod = _pod(rt, "musicgen-medium-smoke", n_slots=2, max_len=40)
    eng = pod.engines[0]
    c, params = eng.container, eng.params
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, c.arch.vocab_size, 6)
    fe = _frontend(rng, eng.fe_len, eng.d_model)
    req = GenRequest(rid=0, prompt=prompt, max_new_tokens=3, frontend=fe)
    sched = ContinuousScheduler(pod)
    sched.submit(req)
    sched.run(max_ticks=100)
    with torch.no_grad():
        logits, _ = c.model.forward(
            params, torch.as_tensor(prompt[None]),
            frontend_embeds=torch.as_tensor(fe[None]).to(c.cache_dtype))
    assert req.tokens[0] == int(torch.argmax(logits[0, -1,
                                                    :c.arch.vocab_size]))
    assert req.state == "done" and len(req.tokens) == 3


def _mixed_trace(Req, d_model=64, n=5):
    """No prefix, then prefixes of 1, 2, 4 (the whole buffer) and 3 rows."""
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(n):
        fl = (None, 1, 2, 4, 3)[i % 5]
        fe = _frontend(rng, fl, d_model) if fl else None
        reqs.append(Req(
            rid=i, prompt=rng.integers(0, 256, int(rng.integers(3, 9))),
            max_new_tokens=int(rng.integers(2, 6)), frontend=fe))
    return reqs


def test_partial_and_absent_prefixes_paged_parity(rt):
    results = []
    for paged in (False, True):
        pod = _pod(rt, "musicgen-medium-smoke", n_slots=2, max_len=40,
                   paged=paged, page_size=8)
        sched = ContinuousScheduler(pod)
        reqs = _mixed_trace(GenRequest)
        sched.submit(reqs)
        sched.run(max_ticks=2000)
        assert all(r.state == "done" for r in reqs)
        assert all(len(r.tokens) == r.max_new_tokens for r in reqs)
        results.append([r.tokens for r in reqs])
        eng = pod.engines[0]
        assert sorted(eng.free) == list(range(eng.n_slots))
        if paged:
            eng.pool.check()
            assert eng.pool.in_use == 0
    assert results[0] == results[1]


def test_prefix_actually_conditions_output(rt):
    pod = _pod(rt, "internvl2-2b-smoke", n_slots=2, max_len=40)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, 6)
    a = GenRequest(rid=0, prompt=prompt, max_new_tokens=4,
                   frontend=_frontend(rng, 4, 64))
    b = GenRequest(rid=1, prompt=prompt, max_new_tokens=4,
                   frontend=5.0 * _frontend(rng, 4, 64))
    sched = ContinuousScheduler(pod)
    sched.submit([a, b])
    sched.run(max_ticks=200)
    assert a.tokens != b.tokens


def test_frontend_rejections(rt):
    rng = np.random.default_rng(9)
    pod = _pod(rt, "llama3.2-3b-smoke", n_slots=2, max_len=56)
    sched = ContinuousScheduler(pod)
    bad = GenRequest(rid=0, prompt=np.arange(4), max_new_tokens=2,
                     frontend=_frontend(rng, 4, 64))
    ok = GenRequest(rid=1, prompt=np.arange(4), max_new_tokens=2)
    sched.submit([bad, ok])
    sched.run(max_ticks=100)
    assert bad.state == "rejected" and "text-only" in bad.error
    assert ok.state == "done"

    pod = _pod(rt, "musicgen-medium-smoke", n_slots=2, max_len=40)
    sched = ContinuousScheduler(pod)
    wide = GenRequest(rid=2, prompt=np.arange(4), max_new_tokens=2,
                      frontend=_frontend(rng, 9, 64))
    thin = GenRequest(rid=3, prompt=np.arange(4), max_new_tokens=2,
                      frontend=_frontend(rng, 4, 32))
    fine = GenRequest(rid=4, prompt=np.arange(4), max_new_tokens=2,
                      frontend=_frontend(rng, 4, 64))
    sched.submit([wide, thin, fine])
    sched.run(max_ticks=100)
    assert wide.state == "rejected" and "exceeds arch frontend_len" in wide.error
    assert thin.state == "rejected" and "d_model" in thin.error
    assert fine.state == "done"


def test_prefix_cache_on_off_parity_on_shared_frontend_trace(rt):
    outs = {}
    with redirect_stdout(io.StringIO()):
        for cache in (False, True):
            args = _serve_args(paged=True)
            args.prefix_cache = cache
            args.shared_prefix = 16
            outs[cache] = serve_continuous(rt, "musicgen-medium-smoke", args)
    assert len(outs[False]["request_tokens"]) == 7
    assert outs[False]["request_tokens"] == outs[True]["request_tokens"]
    assert outs[True]["prefix_cache"]["enabled"]
    assert outs[True]["prefix_cache"]["hits"] == 0
    assert outs[True]["prefix_cache"]["misses"] == 0
    assert outs[True]["prefill_positions"] == outs[False]["prefill_positions"]


def test_frontend_span_counts_against_max_len(rt):
    pod = _pod(rt, "musicgen-medium-smoke", n_slots=1, max_len=20)
    eng = pod.engines[0]
    bad = GenRequest(rid=0, prompt=np.arange(8), max_new_tokens=8)
    sched = ContinuousScheduler(pod)
    sched.submit(bad)
    sched.run(max_ticks=50)
    assert bad.state == "rejected"
    assert "frontend+prompt+gen" in bad.error
    assert not eng.active


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_prefill_logits_match_across_packages(envs, arch):
    """A (3, 4, 64) frontend buffer with 4, 2 and 0 real rows packed ahead
    of 10-token prompts: logits within 1e-4; and the slot prefill's first
    tokens (sampled at fe_len + length - 1) identical."""
    env = envs[arch]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (3, 10)).astype(np.int32)
    fe = (0.02 * rng.standard_normal((3, 4, 64))).astype(np.float32)
    fl = np.array([4, 2, 0], np.int32)
    jl, _ = env["jc"].model.forward(env["jparams"], jnp.asarray(toks),
                                    frontend_embeds=jnp.asarray(fe),
                                    frontend_len=jnp.asarray(fl))
    tl, _ = env["tc"].model.forward(env["tparams"], torch.from_numpy(toks),
                                    frontend_embeds=torch.from_numpy(fe),
                                    frontend_len=torch.from_numpy(fl))
    tp.close(jl, tl)
    # full buffer: the pack is the identity, as the plain concatenation
    jl, _ = env["jc"].model.forward(env["jparams"], jnp.asarray(toks),
                                    frontend_embeds=jnp.asarray(fe))
    tl, _ = env["tc"].model.forward(env["tparams"], torch.from_numpy(toks),
                                    frontend_embeds=torch.from_numpy(fe))
    tp.close(jl, tl)

    lens = np.array([10, 7, 3], np.int32)
    jpre = JBuilder(env["jc"].model, env["jc"].mesh,
                    env["jc"].rules).build_prefill_slot(32, 4)
    tpre = ServeStepBuilder(env["tc"].model).build_prefill_slot(32, 4)
    jf, jcache = jpre(env["jparams"], jnp.asarray(toks), jnp.asarray(lens),
                      jnp.asarray(fe), jnp.asarray(fl))
    tf, tcache = tpre(env["tparams"], torch.from_numpy(toks),
                      torch.from_numpy(lens), torch.from_numpy(fe),
                      torch.from_numpy(fl))
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    tp.close(jcache["stage0"]["b0"]["k"], tcache["stage0"]["b0"]["k"])


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_pod_trace_tokens_identical_across_packages(envs, arch, paged):
    env = envs[arch]
    kw = dict(replicas=1, n_slots=3, max_len=40, paged=paged, page_size=8)
    jp = JPod(env["jrt"], "stable", **kw)
    jreqs = _mixed_trace(JRequest, n=10)
    js = JScheduler(jp)
    js.submit(jreqs)
    js.run(max_ticks=2000)
    tpod = Pod(env["trt"], "stable", platform="cpu",
               params=env["np_params"], **kw)
    treqs = _mixed_trace(GenRequest, n=10)
    ts = ContinuousScheduler(tpod)
    ts.submit(treqs)
    ts.run(max_ticks=2000)
    assert all(r.state == "done" for r in treqs)
    assert [list(r.tokens) for r in jreqs] == [list(r.tokens) for r in treqs]
    je, te = jp.engines[0], tpod.engines[0]
    assert te.prefill_positions == je.prefill_positions
    assert te.decode_ticks == je.decode_ticks
