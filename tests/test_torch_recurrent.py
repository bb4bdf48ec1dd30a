"""The port's recurrent families against the JAX package, on the CPU:
mamba2-2.7b-smoke (``ssm`` blocks) and recurrentgemma-2b-smoke (``rec``
blocks + local-window attention, window 16), with the JAX package's
weights handed over as numpy.

Tolerances, all float32:

* 1e-5 (absolute, or relative to the output's max for the SSD scans) for
  single functions and kernels' plain versions: sums in another order;
* 1e-4 for logits of a whole model, as the llama serving tests.

Greedy tokens are compared for equality. The recurrentgemma prompts are
longer than its window, so the prefill's ring roll and the decode's ring
wrap are both covered; mamba2-smoke prompts are multiples of its
``ssm_chunk`` (8), the reference's rule for a cached prefill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.runtime import Runtime as JRuntime
from repro.kernels.rglru_scan.ref import rglru_scan_ref as j_rglru_ref
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.models import rglru as j_rglru
from repro.models import ssm as j_ssm
from repro.orchestrator import ContinuousScheduler as JScheduler
from repro.orchestrator import GenRequest as JRequest
from repro.orchestrator import Pod as JPod
from repro.serve.serve_step import ServeStepBuilder as JBuilder
from repro.serve.serve_step import greedy_sample as j_greedy
from repro_torch.core.runtime import Runtime
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import _ssd_chunked, ssd_ref
from repro_torch.models import rglru, ssm
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.orchestrator import ContinuousScheduler, GenRequest, Pod

pytestmark = pytest.mark.orchestrator

ARCHS = ("mamba2-2.7b-smoke", "recurrentgemma-2b-smoke")

IMAGEFILE = """
FROM scratch
ARCH {arch}
SHAPE decode_32k seq_len=64 global_batch=4
MESH local
PRECISION compute=float32 params=float32
COLLECTIVES generic
"""

TOL = 1e-5
LOGIT_TOL = 1e-4

# tests/test_kernels.py:93 and :121 (the JAX kernel suites' cases)
RG_CASES = [(2, 64, 128), (1, 100, 256), (3, 32, 512), (1, 128, 128)]
SSD_CASES = [(2, 64, 4, 32, 32, 16), (1, 128, 8, 64, 128, 32),
             (2, 96, 2, 16, 64, 32), (1, 256, 4, 64, 128, 64)]


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stevedore")
    out = {}
    for arch in ARCHS:
        jrt = JRuntime(root / arch / "jax")
        jrt.build(IMAGEFILE.format(arch=arch), tag="stable")
        trt = Runtime(root / arch / "torch")
        trt.build(IMAGEFILE.format(arch=arch), tag="stable")
        jc = jrt.run("stable")
        tc = trt.run("stable", platform="cpu")
        jparams = jc.init_params(0)
        np_params = jax.tree.map(np.asarray, jparams)
        out[arch] = dict(jrt=jrt, trt=trt, jc=jc, tc=tc, jparams=jparams,
                         np_params=np_params,
                         tparams=tc.load_params(np_params))
    return out


def _err(j, t) -> float:
    return float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())


def _rel(j, t) -> float:
    j = np.asarray(j, np.float32)
    return _err(j, t) / (float(np.abs(j).max()) + 1e-9)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _layer0(env, block: str, name: str):
    """Block ``block`` of stage 0, layer 0, sub-tree ``name``: (jax, torch)."""
    jp = jax.tree.map(lambda a: a[0], env["jparams"]["stage0"][block][name])
    tp = tree_map(lambda a: a[0], env["tparams"]["stage0"][block][name])
    return jp, tp


# ---------------------------------------------------------------------------
# kernels' plain versions against the JAX oracles
# ---------------------------------------------------------------------------

def _ssd_inputs(case, seed=0):
    b, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32)
    C = rng.standard_normal((b, S, N)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_plain_versions_match_jax(case):
    """The sequential oracle and the chunked version (y and final state)
    against the JAX package's, relative to the output's max."""
    x, dt, A, B, C = _ssd_inputs(case)
    chunk = case[-1]
    jy = j_ssd_ref(*map(jnp.asarray, (x, dt, A, B, C)))
    ty = ssd_ref(*map(_t, (x, dt, A, B, C)))
    assert _rel(jy, ty) < TOL
    jyc, jstate = j_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                                     chunk)
    tyc, tstate = _ssd_chunked(*map(_t, (x, dt, A, B, C)), chunk)
    assert _rel(jyc, tyc) < TOL
    assert _rel(jstate, tstate) < TOL
    assert _rel(jy, tyc) < 1e-4          # chunked vs sequential, as the suite
    # the CPU path of the public entry point is the chunked version
    y_op, s_op = ssd_ops.ssd(*map(_t, (x, dt, A, B, C)), chunk)
    assert torch.equal(y_op, tyc) and torch.equal(s_op, tstate)
    with pytest.raises(ValueError, match="must divide"):
        ssd_ops.ssd(*map(_t, (x, dt, A, B, C)), chunk + 1)


@pytest.mark.parametrize("case", RG_CASES, ids=str)
def test_rglru_plain_scan_matches_jax(case):
    """The sequential plain version against the JAX oracle and against the
    JAX model's associative scan (f32 rounding)."""
    rng = np.random.default_rng(1)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(case)))).astype(np.float32)
    b = rng.standard_normal(case).astype(np.float32)
    th = rglru_scan_ref(_t(a), _t(b))
    assert _err(j_rglru_ref(jnp.asarray(a), jnp.asarray(b)), th) < TOL
    assert _err(j_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(b)), th) < TOL


# ---------------------------------------------------------------------------
# block functions against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", ["ssm", "rglru"])
def test_causal_conv_matches_jax(mod):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    jm, tm = (j_ssm, ssm) if mod == "ssm" else (j_rglru, rglru)
    out = tm._causal_conv(_t(x), _t(w), _t(b))
    assert _err(jm._causal_conv(*map(jnp.asarray, (x, w, b))), out) < TOL


def test_ssm_forward_and_decode_match_jax(envs):
    env = envs["mamba2-2.7b-smoke"]
    cfg = env["tc"].arch
    jp, tp = _layer0(env, "b0", "ssm")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jout, jcache = j_ssm.ssm_forward(jp, jnp.asarray(x), cfg,
                                     return_cache=True)
    tout, tcache = ssm.ssm_forward(tp, _t(x), cfg, return_cache=True)
    assert _err(jout, tout) < TOL
    assert _err(jcache["conv"], tcache["conv"]) < TOL
    assert _err(jcache["state"], tcache["state"]) < TOL
    # without a cache, a ragged length pads to the chunk (reference rule)
    assert _err(j_ssm.ssm_forward(jp, jnp.asarray(x[:, :13]), cfg),
                ssm.ssm_forward(tp, _t(x[:, :13]), cfg)) < TOL
    for fwd, xx in ((j_ssm.ssm_forward, jnp.asarray(x[:, :12])),
                    (ssm.ssm_forward, _t(x[:, :12]))):
        with pytest.raises(ValueError, match="divisible by ssm_chunk"):
            fwd(jp if fwd is j_ssm.ssm_forward else tp, xx, cfg,
                return_cache=True)
    xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jo, jn = j_ssm.ssm_decode(jp, jnp.asarray(xt), jcache, cfg)
    to, tn = ssm.ssm_decode(tp, _t(xt), tcache, cfg)
    assert _err(jo, to) < TOL
    assert _err(jn["conv"], tn["conv"]) < TOL
    assert _err(jn["state"], tn["state"]) < TOL


def test_rec_forward_and_decode_match_jax(envs):
    env = envs["recurrentgemma-2b-smoke"]
    cfg = env["tc"].arch
    jp, tp = _layer0(env, "b0", "rec")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    xr = rng.standard_normal((2, 20, cfg.rnn_width_)).astype(np.float32)
    ja, jb = j_rglru._rglru_coeffs(jp, jnp.asarray(xr))
    ta, tb = rglru._rglru_coeffs(tp, _t(xr))
    assert _err(ja, ta) < TOL and _err(jb, tb) < TOL
    assert _err(j_rglru.rec_forward(jp, jnp.asarray(x), cfg),
                rglru.rec_forward(tp, _t(x), cfg)) < TOL
    K, R = cfg.conv_kernel, cfg.rnn_width_
    cache_np = {"conv": rng.standard_normal((2, K - 1, R)).astype(np.float32),
                "state": rng.standard_normal((2, R)).astype(np.float32)}
    xt = x[:, :1]
    jo, jn = j_rglru.rec_decode(jp, jnp.asarray(xt),
                                jax.tree.map(jnp.asarray, cache_np), cfg)
    to, tn = rglru.rec_decode(tp, _t(xt), tree_map(_t, cache_np), cfg)
    assert _err(jo, to) < TOL
    assert _err(jn["conv"], tn["conv"]) < TOL
    assert _err(jn["state"], tn["state"]) < TOL


def test_init_caches_match_jax():
    for arch in ARCHS:
        from repro_torch.configs import get_config
        from repro.configs import get_config as j_get_config
        cfg, jcfg = get_config(arch), j_get_config(arch)
        if cfg.family == "ssm":
            pairs = (ssm.init_ssm_cache(2, 3, cfg, torch.bfloat16),
                     j_ssm.init_ssm_cache(2, 3, jcfg, jnp.bfloat16))
        else:
            pairs = (rglru.init_rec_cache(2, 3, cfg, torch.bfloat16),
                     j_rglru.init_rec_cache(2, 3, jcfg, jnp.bfloat16))
        for k in ("conv", "state"):
            assert tuple(pairs[0][k].shape) == pairs[1][k].shape
            assert str(pairs[0][k].dtype).split(".")[-1] == \
                str(pairs[1][k].dtype)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def test_params_from_jax_carries_recurrent_leaves(envs):
    """Every leaf, the recurrent ones included, is a bitwise copy."""
    names = {"mamba2-2.7b-smoke": ("conv_w", "conv_b", "A_log", "D",
                                   "dt_bias", "gate_norm", "wdt"),
             "recurrentgemma-2b-smoke": ("conv_w", "gate_a_w", "gate_a_b",
                                         "gate_x_w", "gate_x_b", "lam")}
    for arch, leaves in names.items():
        env = envs[arch]
        flat_j = jax.tree.leaves(env["np_params"])
        flat_t = tree_leaves(env["tparams"])
        assert len(flat_j) == len(flat_t)
        for a, b in zip(flat_j, flat_t):
            np.testing.assert_array_equal(a, b.numpy())
        blk = env["tparams"]["stage0"]["b0"]
        sub = blk["ssm"] if "ssm" in blk else blk["rec"]
        for name in leaves:
            np.testing.assert_array_equal(
                sub[name].numpy(),
                env["np_params"]["stage0"]["b0"][
                    "ssm" if "ssm" in blk else "rec"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_greedy_decode(envs, arch):
    """Prefill logits of a 24-token prompt (longer than recurrentgemma's
    window), then 8 greedy decode steps at per-row positions (the ring
    wraps): the same tokens and logits in both packages."""
    env = envs[arch]
    rng = np.random.default_rng(5)
    B, P, L = 2, 24, 40
    toks = rng.integers(0, 256, (B, P)).astype(np.int32)
    jm, tm = env["jc"].model, env["tc"].model
    j_decode = jax.jit(jm.decode_step)
    jlog, jcache, _ = jm.forward(env["jparams"], jnp.asarray(toks),
                                 collect_cache=True, cache_len=L)
    tlog, tcache, _ = tm.forward(env["tparams"], _t(toks).long(),
                                 collect_cache=True, cache_len=L)
    assert _err(jlog, tlog) < LOGIT_TOL
    for a, b in zip(jax.tree.leaves(jcache), tree_leaves(tcache)):
        assert a.shape == tuple(b.shape) and _err(a, b) < LOGIT_TOL
    jt = np.asarray(jlog[:, -1]).argmax(-1).astype(np.int32)
    tt = tlog[:, -1].numpy().argmax(-1).astype(np.int32)
    assert (jt == tt).all()
    for step in range(8):
        pos = np.full((B,), P + step, np.int32)
        jlog, jcache = j_decode(env["jparams"], jcache,
                                jnp.asarray(jt[:, None]), jnp.asarray(pos))
        tlog, tcache = tm.decode_step(env["tparams"], tcache,
                                      _t(tt[:, None]).long(), _t(pos))
        assert _err(jlog, tlog) < LOGIT_TOL, step
        jt = np.asarray(jlog[:, -1]).argmax(-1).astype(np.int32)
        tt = tlog[:, -1].numpy().argmax(-1).astype(np.int32)
        assert (jt == tt).all(), step


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_decode_matches_jax_lockstep_generate(envs, arch):
    """The port's mirror of test_orchestrator.py's arch sweep: the JAX
    lockstep prefill + generate loop and the port's Pod +
    ContinuousScheduler (slot-granular, chunked decode) give the same
    tokens on one batch."""
    env = envs[arch]
    jc = env["jc"]
    B, P, G = 4, 8, 6
    rng = np.random.default_rng(2)
    prompts = np.asarray(rng.integers(0, 256, (B, P)), np.int32)
    b = JBuilder(jc.model, jc.mesh, jc.rules)
    last, cache = jax.jit(b.build_prefill(56))(env["jparams"],
                                               jnp.asarray(prompts))
    first = j_greedy(last, jc.arch.vocab_size)[:, None]
    ref_toks, _ = jax.jit(b.build_generate_loop(G - 1))(
        env["jparams"], cache, first, jnp.int32(P))
    ref = np.concatenate([np.asarray(first), np.asarray(ref_toks)], axis=1)

    pod = Pod(env["trt"], "stable", replicas=1, n_slots=4, max_len=56,
              platform="cpu", params=env["np_params"])
    assert pod.engines[0].exact_prefill
    sched = ContinuousScheduler(pod, fairness_cap=4)
    reqs = [GenRequest(rid=i, prompt=prompts[i], max_new_tokens=G)
            for i in range(B)]
    sched.submit(reqs)
    sched.run(max_ticks=1000)
    np.testing.assert_array_equal(ref, np.asarray([r.tokens for r in reqs]))


def _trace(Req, arch):
    """Mixed lengths through a 3-slot bank: recurrentgemma prompts of 5-30
    tokens (past its 16-window), mamba2 prompts of 8, 16 or 24 (chunk
    multiples) or shorter than its chunk."""
    rng = np.random.default_rng(6)
    reqs = []
    for i in range(8):
        if arch.startswith("mamba2"):
            n = int(rng.choice([3, 5, 8, 16, 24]))
        else:
            n = int(rng.integers(5, 31))
        reqs.append(Req(rid=i, prompt=rng.integers(0, 256, n),
                        max_new_tokens=int(rng.integers(2, 12)),
                        arrival=i // 3))
    return reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_trace_tokens_identical_across_packages(envs, arch):
    env = envs[arch]
    kw = dict(replicas=1, n_slots=3, max_len=48)
    jp = JPod(env["jrt"], "stable", **kw)
    jreqs = _trace(JRequest, arch)
    js = JScheduler(jp)
    js.submit(jreqs)
    js.run()
    tp = Pod(env["trt"], "stable", platform="cpu", params=env["np_params"],
             **kw)
    treqs = _trace(GenRequest, arch)
    ts = ContinuousScheduler(tp)
    ts.submit(treqs)
    ts.run()
    assert all(r.state == "done" for r in treqs)
    assert [list(r.tokens) for r in jreqs] == [list(r.tokens) for r in treqs]
    je, te = jp.engines[0], tp.engines[0]
    assert te.prefill_positions == je.prefill_positions
    assert te.decode_ticks == je.decode_ticks
    assert tp.metrics.snapshot()["histograms"] == \
        jp.metrics.snapshot()["histograms"]
    assert sorted(te.free) == list(range(te.n_slots))


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_re_prefills_recurrent_state(envs, arch):
    """A request resumed mid-decode (the scheduler's preempted-request
    path) re-prefills prompt + generated tokens into a fresh slot, which
    rebuilds the conv tails and recurrent states: its continuation equals
    the uninterrupted run token for token."""
    env = envs[arch]
    prompt = np.random.default_rng(7).integers(0, 256, 8)
    pod = Pod(env["trt"], "stable", replicas=1, n_slots=2, max_len=48,
              decode_chunk=1, platform="cpu", params=env["np_params"])
    sched = ContinuousScheduler(pod)
    full = GenRequest(rid=0, prompt=prompt, max_new_tokens=12)
    sched.submit(full)
    sched.run(max_ticks=100)
    eng = pod.engines[0]
    # 9 tokens done: the re-prefill covers 8 + 8 = 16 positions
    resumed = GenRequest(rid=1, prompt=prompt, max_new_tokens=12)
    resumed.tokens = list(full.tokens[:9])
    resumed.state = "preempted"
    eng.start(resumed, tick=0)
    assert eng.resumes == 1
    while eng.active:
        eng.tick(0)
    assert resumed.tokens == full.tokens


def test_cache_dtypes_follow_the_reference_rule(envs, tmp_path):
    """With a bfloat16 compute dtype, every slot-cache leaf has the dtype
    of the JAX package's ``_abstract_cache``: recurrent states float32,
    KV and conv tails bfloat16."""
    for arch in ARCHS:
        text = IMAGEFILE.format(arch=arch).replace(
            "compute=float32", "compute=bfloat16")
        jrt = JRuntime(tmp_path / arch / "jax")
        jrt.build(text, tag="bf")
        trt = Runtime(tmp_path / arch / "torch")
        trt.build(text, tag="bf")
        jspecs = jax.tree.leaves(jrt.run("bf").slot_cache_specs(3, 40))
        tcache = tree_leaves(trt.run("bf", platform="cpu")
                             .init_slot_cache(3, 40))
        assert len(jspecs) == len(tcache)
        got = [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tcache]
        want = [(s.shape, str(s.dtype)) for s in jspecs]
        assert got == want
        assert {d for _, d in got} == {"float32", "bfloat16"}


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serving_raises_for_recurrent_archs(envs, arch):
    env = envs[arch]
    with pytest.raises(NotImplementedError):
        JPod(env["jrt"], "stable", replicas=1, n_slots=2, max_len=32,
             paged=True, page_size=8)
    with pytest.raises(NotImplementedError, match="contiguous"):
        Pod(env["trt"], "stable", replicas=1, n_slots=2, max_len=32,
            paged=True, page_size=8, platform="cpu",
            params=env["np_params"])
    with pytest.raises(NotImplementedError, match="contiguous"):
        env["tc"].model.paged_cache_defs(8, 8)
