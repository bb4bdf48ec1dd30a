"""tests/test_orchestrator.py on the port, first half: slot hygiene, FIFO
admission, slot decode against the whole-batch lockstep path, chunk 1
against chunk 4, EOS, rolling upgrades, queue validation and oversized
rejection -- on ``repro_torch``, against the JAX package, on the CPU
(llama3.2-3b-smoke in float32, the JAX package's seed-0 weights). The
paged path and the regressions are in test_torch_orchestrator_paged.py.

Each port test runs the reference test's body through
``torch_ref.check_both``: once on the JAX package as written, once on the
port (the same body, its ``repro`` names pointing at the port, the
``local`` platform on the CPU, the JAX package's weights loaded). Besides
the body's own assertions, both runs must agree exactly on every request
(tokens, state, finish reason, error, admit/done ticks, replica), every
pod (rejections, sheds, engine counters, free slots, positions, pool
state, the metrics snapshot and every span) and every scheduler (tick,
admission order, rejections).

``test_slot_decode_matches_lockstep_generate`` calls ``jax.jit`` on the
JAX package's serve steps, so its port test is written out: the port's
``ServeStepBuilder.build_prefill`` + ``build_generate_loop`` from the
scalar start against the port's Pod, and both against the JAX package's
lockstep tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_orchestrator as ref
import torch_ref
from repro.orchestrator import Pod as JPod
from repro.serve.serve_step import ServeStepBuilder as JBuilder
from repro.serve.serve_step import greedy_sample as j_greedy_sample
from repro_torch.orchestrator import ContinuousScheduler, GenRequest, Pod
from repro_torch.serve.serve_step import ServeStepBuilder, greedy_sample

pytestmark = pytest.mark.orchestrator


@pytest.fixture(scope="module")
def rts(tmp_path_factory):
    return torch_ref.runtimes(tmp_path_factory.mktemp("stevedore"),
                              ref.IMAGEFILE)


def _rt(rts):
    return lambda pkg, port: (rts[port],)


def _pod(rts):
    """The reference's ``pod`` fixture, built in each package's run."""
    return lambda pkg, port: (pkg.Pod(rts[port], "stable", replicas=2,
                                      n_slots=3, max_len=56),)


def test_no_slot_leaks_mixed_lengths(rts):
    """Mirrors test_orchestrator.py::test_no_slot_leaks_mixed_lengths."""
    t = torch_ref.check_both(ref, "test_no_slot_leaks_mixed_lengths",
                             _pod(rts))
    assert len(t["requests"]) == 20


def test_fifo_admission_order_preserved(rts):
    """Mirrors test_orchestrator.py::test_fifo_admission_order_preserved."""
    torch_ref.check_both(ref, "test_fifo_admission_order_preserved",
                         _pod(rts))


@pytest.mark.parametrize("arch", ["llama3.2-3b-smoke",
                                  "recurrentgemma-2b-smoke",
                                  "mamba2-2.7b-smoke"])
def test_slot_decode_matches_lockstep_generate(rts, arch):
    """Mirrors test_orchestrator.py::
    test_slot_decode_matches_lockstep_generate:
    the port's whole-batch path (``build_prefill(56)``, then
    ``build_generate_loop(5)`` from the scalar start P) equals the port's
    continuous slot decode token for token, and both equal the JAX
    package's lockstep tokens (its ``jax.jit`` of the same steps)."""
    tag = f"par-{arch}"
    imagefile = ref.IMAGEFILE.replace("llama3.2-3b-smoke", arch)
    B, P, G = 4, 8, 6
    jrt, trt = rts[False], rts[True]
    jrt.build(imagefile, tag=tag)
    trt.build(imagefile, tag=tag)
    jeng = JPod(jrt, tag, replicas=1, n_slots=4, max_len=56).engines[0]
    jc, jparams = jeng.container, jeng.params
    cfg = jc.arch
    prompts = np.asarray(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, P)), np.int32)
    jb = JBuilder(jc.model, jc.mesh, jc.rules)
    last, cache = jax.jit(jb.build_prefill(56))(jparams, jnp.asarray(prompts))
    first = j_greedy_sample(last, cfg.vocab_size)[:, None]
    toks, _ = jax.jit(jb.build_generate_loop(G - 1))(jparams, cache, first,
                                                     jnp.int32(P))
    want = np.concatenate([np.asarray(first), np.asarray(toks)], axis=1)

    pod = Pod(trt, tag, replicas=1, n_slots=4, max_len=56, platform="cpu",
              params=jax.tree.map(np.asarray, jparams))
    eng = pod.engines[0]
    c, params = eng.container, eng.params
    b = ServeStepBuilder(c.model)
    with torch.no_grad():
        last, cache = b.build_prefill(56)(params,
                                          torch.from_numpy(prompts).long())
        first = greedy_sample(last, cfg.vocab_size)[:, None]
        toks, _ = b.build_generate_loop(G - 1)(
            params, cache, first, torch.tensor(P, dtype=torch.int32))
    lockstep = torch.cat([first, toks], dim=1).numpy()

    sched = ContinuousScheduler(pod, fairness_cap=4)
    reqs = [GenRequest(rid=i, prompt=prompts[i], max_new_tokens=G)
            for i in range(B)]
    sched.submit(reqs)
    sched.run(max_ticks=1000)
    np.testing.assert_array_equal(lockstep, np.asarray([r.tokens
                                                        for r in reqs]))
    np.testing.assert_array_equal(want, lockstep)


def test_decode_chunk1_matches_chunk4(rts):
    """Mirrors test_orchestrator.py::test_decode_chunk1_matches_chunk4."""
    torch_ref.check_both(ref, "test_decode_chunk1_matches_chunk4", _rt(rts))


def test_eos_frees_slot_early(rts):
    """Mirrors test_orchestrator.py::test_eos_frees_slot_early."""
    torch_ref.check_both(ref, "test_eos_frees_slot_early", _rt(rts))


def test_rolling_upgrade_drains_in_flight(rts):
    """Mirrors test_orchestrator.py::test_rolling_upgrade_drains_in_flight
    (both runtimes' ``stable`` re-pointed at the r2 image, as in the
    reference module)."""
    t = torch_ref.check_both(ref, "test_rolling_upgrade_drains_in_flight",
                             _rt(rts))
    assert t["pods"][0]["retired"]


def test_upgrade_noop_when_digest_unchanged(rts):
    """Mirrors test_orchestrator.py::
    test_upgrade_noop_when_digest_unchanged."""
    torch_ref.check_both(ref, "test_upgrade_noop_when_digest_unchanged",
                         _rt(rts))


def test_queue_rejects_oversized_and_dup():
    """Mirrors test_orchestrator.py::test_queue_rejects_oversized_and_dup."""
    torch_ref.check_both(ref, "test_queue_rejects_oversized_and_dup")


def test_oversized_request_rejected_not_fatal(rts):
    """Mirrors test_orchestrator.py::
    test_oversized_request_rejected_not_fatal."""
    torch_ref.check_both(ref, "test_oversized_request_rejected_not_fatal",
                         _rt(rts))
