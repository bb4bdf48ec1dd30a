"""The port's cross-host fabric against the JAX package's, on the CPU, on
llama3.2-3b-smoke in float32.

* codec: ``encode_request``/``encode_frame`` give the same bytes in both
  packages (bare requests, frontend embeddings, resume state), a frame
  from either package decodes in the other, stray lines are skipped;
* the invariants of ``tests/test_fabric.py`` on the port: fleet tokens
  equal one scheduler's, eviction drops exactly the victim's ring
  entries, a dead pod's work reroutes exactly once and resumes bitwise,
  a flapping link never evicts or duplicates, infeasible requests are
  rejected at the floor, and the ledgers (``PodRouter``'s after deadline
  sheds, the fabric's through churn) settle to zero;
* the same loopback kill, and the same elastic fleet, in both packages
  (fig12's arms B and C at its smoke size, the JAX package run here):
  equal ticks, evictions, reroutes, rerouted rids, closure, tokens, and
  equal peak, spawned and retired pod counts;
* one process fleet on the CPU with ``jax`` and ``repro`` unimportable in
  its workers: a worker killed with SIGKILL mid-decode loses nothing and
  the tokens equal the loopback fleet's.

Cross-package runs serve the JAX package's seed-0 weights, handed to the
port's pods as numpy (``Pod(params=)``); port-only runs use the port's own
seed-0 init. Greedy tokens and tick counters are compared for equality.
"""

import os
import signal

import jax
import numpy as np
import pytest

from repro.core.runtime import Runtime as JRuntime
from repro.orchestrator import FabricRouter as JFabricRouter
from repro.orchestrator import GenRequest as JRequest
from repro.orchestrator import decode_request as j_decode_request
from repro.orchestrator import encode_request as j_encode_request
from repro.orchestrator import loopback_spawner as j_loopback_spawner
from repro.orchestrator.fabric import decode_frame as j_decode_frame
from repro.orchestrator.fabric import encode_final as j_encode_final
from repro.orchestrator.fabric import encode_frame as j_encode_frame
from repro.orchestrator.obs import \
    validate_fleet_closure as j_validate_fleet_closure
from repro_torch.core.runtime import Runtime
from repro_torch.orchestrator import (ContinuousScheduler, FabricRouter,
                                      GenRequest, Pod, PodRouter,
                                      decode_request, encode_request,
                                      load_fleet_spans, loopback_spawner,
                                      proc_spawner)
from repro_torch.orchestrator.fabric import (decode_frame, encode_final,
                                             encode_frame)
from repro_torch.orchestrator.obs import (validate_fleet_closure,
                                          validate_span_log)

pytestmark = pytest.mark.orchestrator

IMAGEFILE = """
FROM scratch
ARCH llama3.2-3b-smoke
SHAPE decode_32k seq_len=64 global_batch=4
MESH local
PRECISION compute=float32 params=float32
COLLECTIVES generic
"""

POD_KWARGS = dict(replicas=1, n_slots=2, max_len=96)
PORT_POD = dict(POD_KWARGS, platform="cpu")
MAX_TICKS = 5000


@pytest.fixture(scope="module")
def rt(tmp_path_factory):
    rt = Runtime(tmp_path_factory.mktemp("stevedore"))
    rt.build(IMAGEFILE, tag="stable")
    return rt


@pytest.fixture(scope="module")
def jrt(tmp_path_factory):
    jrt = JRuntime(tmp_path_factory.mktemp("jax"))
    jrt.build(IMAGEFILE, tag="stable")
    return jrt


@pytest.fixture(scope="module")
def np_params(jrt):
    return jax.tree.map(np.asarray, jrt.run("stable").init_params(0))


def _requests(n, *, seed=0, arrive_per_tick=6, R=GenRequest):
    rng = np.random.default_rng(seed)
    return [R(rid=i,
              prompt=rng.integers(0, 256, int(rng.integers(4, 16))),
              max_new_tokens=int(rng.integers(4, 14)),
              arrival=i // arrive_per_tick) for i in range(n)]


def _fig12_trace(n, R):
    """benchmarks/fig12_fabric.py's trace (its smoke size is n=12)."""
    rng = np.random.default_rng(0)
    return [R(rid=i,
              prompt=rng.integers(0, 256, int(rng.integers(4, 16))),
              max_new_tokens=int(rng.integers(6, 20)),
              arrival=i // 6) for i in range(n)]


def _fabric(rt, **kw):
    spawn = loopback_spawner(rt, rt.pull("stable"), pod_kwargs=PORT_POD)
    kw.setdefault("fleet", f"t{abs(hash(str(sorted(kw.items())))) % 10**8}")
    return FabricRouter(spawn, runtime=rt, **kw)


def _drain(router):
    while router.busy and router.tick < MAX_TICKS:
        router.step()
    assert not router.busy, "fabric run did not converge"


def _oracle(rt, reqs):
    """One pod + scheduler serving the whole trace: greedy decode and
    seeded params make tokens a function of (prompt, budget) only."""
    pod = Pod(rt, "stable", **PORT_POD)
    sched = ContinuousScheduler(pod)
    sched.submit(reqs)
    sched.run(max_ticks=MAX_TICKS)
    assert all(r.state == "done" for r in reqs)
    return {r.rid: list(r.tokens) for r in reqs}


def _kill_mid_decode(router, kill=lambda m: m.transport.kill()):
    """Step until a member holds a request with committed tokens that has
    not finished, then ``kill`` that member; returns it."""
    while router.busy and router.tick < MAX_TICKS:
        victim = next(
            (m for m in router.members.values()
             if any(r.tokens and len(r.tokens) < r.max_new_tokens
                    for r in m.assigned.values())),
            None)
        if victim is not None:
            kill(victim)
            return victim
        router.step()
    raise AssertionError("no member was ever mid-decode")


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def _codec_case(kind, R):
    rng = np.random.default_rng(3)
    if kind == "bare":
        return R(rid=1, prompt=np.arange(3), max_new_tokens=2)
    req = R(rid=42, prompt=rng.integers(0, 256, 9), max_new_tokens=12,
            eos_id=7, arrival=3,
            frontend=(rng.standard_normal((5, 16)).astype(np.float32)
                      if kind != "resume" else None),
            prefix_len=4, priority="batch", deadline_ticks=50)
    if kind == "resume":
        # mid-flight resume state: what a re-route carries to a survivor
        req.state = "preempted"
        req.tokens = [11, 22, 33]
        req.submit_tick, req.admit_tick = 2, 5
        req.preemptions, req.reroutes = 1, 1
    return req


FIELDS = ("rid", "max_new_tokens", "eos_id", "arrival", "prefix_len",
          "priority", "deadline_ticks", "state", "tokens", "submit_tick",
          "admit_tick", "preemptions", "reroutes")


@pytest.mark.parametrize("kind", ["bare", "frontend", "resume"])
def test_codec_bytes_equal_jax_and_frames_cross_decode(kind):
    req, jreq = _codec_case(kind, GenRequest), _codec_case(kind, JRequest)
    frame = encode_frame({"t": "submit", "req": encode_request(req)})
    jframe = j_encode_frame({"t": "submit", "req": j_encode_request(jreq)})
    assert frame == jframe
    req.state, jreq.state = "done", "done"
    assert encode_frame(encode_final(req)) == j_encode_frame(
        j_encode_final(jreq))
    # each package decodes the other's frame into the same request
    for back in (decode_request(decode_frame(jframe)["req"]),
                 j_decode_request(j_decode_frame(frame)["req"])):
        np.testing.assert_array_equal(back.prompt, np.asarray(jreq.prompt))
        assert back.prompt.dtype == np.int32
        if kind == "frontend":
            np.testing.assert_array_equal(back.frontend, jreq.frontend)
            assert back.frontend.dtype == np.float32
        else:
            assert back.frontend is None
        for f in FIELDS:
            want = getattr(jreq, f)
            if f == "state":
                want = "preempted" if kind == "resume" else "queued"
            assert getattr(back, f) == want, f


def test_frame_codec_skips_stray_output():
    msg = {"t": "hb", "tick": 7, "pod": "fab-0"}
    raw = encode_frame(msg)
    assert raw.startswith(b"\x1e") and raw.endswith(b"\n")
    assert raw == j_encode_frame(msg)
    for dec in (decode_frame, j_decode_frame):
        assert dec(raw) == msg
        assert dec(raw.decode()) == msg                # str form too
        # a worker's stdout carries library prints too: only frames parse
        assert dec(b"some library print\n") is None
        assert dec(b"\x1enot json\n") is None
        assert dec(b"\x1e[1,2]\n") is None             # frames are objects
        assert dec(b"print " + raw) is None            # marker mid-line


# ---------------------------------------------------------------------------
# tests/test_fabric.py's invariants on the port
# ---------------------------------------------------------------------------

def test_loopback_fleet_token_parity_with_single_scheduler(rt):
    oracle = _oracle(rt, _requests(14))
    router = _fabric(rt, pods=2, min_pods=2)
    reqs = _requests(14)
    router.submit(reqs)
    _drain(router)
    assert all(r.state == "done" for r in reqs)
    assert {r.rid: list(r.tokens) for r in reqs} == oracle
    assert router.outstanding_total == 0
    buffers = router.trace_buffers()
    validate_span_log(buffers)
    closure = validate_fleet_closure(buffers)
    assert closure["routed"] == closure["closed"] == 14
    router.close()


def test_eviction_removes_exactly_victims_ring_entries(rt):
    router = _fabric(rt, pods=3, min_pods=1, policy="consistent-hash",
                     vnodes=16)
    before = list(router._ring)
    victim = list(router.members.values())[1]
    victim.transport.kill()
    router.step()
    assert victim.pod_id not in router.members
    expect = [(h, p) for h, p in before if p != victim.pod_id]
    assert router._ring == expect
    assert len(before) - len(router._ring) == 16
    assert router._ring_keys == [h for h, _ in router._ring]
    _drain(router)
    router.close()


def test_reroute_exactly_once_and_bitwise_resume(rt):
    oracle = _oracle(rt, _requests(14))
    router = _fabric(rt, pods=2, min_pods=2)
    reqs = _requests(14)
    router.submit(reqs)
    victim = _kill_mid_decode(router)
    inflight = sorted(victim.assigned)
    assert inflight, "victim had no in-flight work at kill time"
    _drain(router)
    assert all(r.state == "done" for r in reqs)
    assert {r.rid: list(r.tokens) for r in reqs} == oracle
    fab = router.status()["fabric"]
    assert fab["evictions"] == 1
    assert fab["reroutes"] == len(inflight)
    for r in reqs:
        assert r.reroutes == (1 if r.rid in inflight else 0), r.rid
    assert router.outstanding_total == 0
    buffers = router.trace_buffers()
    validate_span_log(buffers)
    closure = validate_fleet_closure(buffers)
    assert closure["rerouted"] == len(inflight)
    spans = [e for b in buffers for e in b.events()]
    for rid in inflight:
        names = [e.name for e in spans if e.rid == rid]
        assert names.count("route") == 1
        assert names.count("reroute") == 1
    router.close()


def test_flapping_member_never_evicted_or_duplicated(rt):
    oracle = _oracle(rt, _requests(10))
    router = _fabric(rt, pods=2, min_pods=2, heartbeat_every=1,
                     miss_limit=4)
    reqs = _requests(10)
    router.submit(reqs)
    flappy = next(iter(router.members.values()))
    for _ in range(3):
        if not router.busy:
            break
        flappy.transport.muted = 2       # drop heartbeat + step replies
        router.step()
        assert flappy.pod_id in router.members, "flapping pod evicted"
        assert flappy.missed < router.miss_limit
        router.step()
        assert flappy.missed == 0
    _drain(router)
    assert all(r.state == "done" for r in reqs)
    assert {r.rid: list(r.tokens) for r in reqs} == oracle
    fab = router.status()["fabric"]
    assert fab["evictions"] == 0 and fab["reroutes"] == 0
    assert all(r.reroutes == 0 and r.preemptions == 0 for r in reqs)
    assert router.outstanding_total == 0
    validate_span_log(router.trace_buffers())
    router.close()


def test_draining_floor_and_infeasible_reject(rt):
    router = _fabric(rt, pods=1, min_pods=1)
    huge = GenRequest(rid=0, prompt=np.arange(1, 80), max_new_tokens=80)
    ok = GenRequest(rid=1, prompt=np.arange(1, 6), max_new_tokens=4)
    router.submit([huge, ok])
    _drain(router)
    assert huge.state == "rejected"
    assert huge.finish_reason == "oversized" and huge.error
    assert ok.state == "done" and len(ok.tokens) == 4
    assert router.outstanding_total == 0
    closure = validate_fleet_closure(router.trace_buffers())
    assert closure["routed"] == 1 and closure["closed"] == 1
    router.close()


def test_podrouter_ledger_settles_after_deadline_sheds(rt):
    pod = Pod(rt, "stable", replicas=1, n_slots=1, max_len=64,
              platform="cpu")
    router = PodRouter([pod])
    hog = GenRequest(rid=0, prompt=np.arange(1, 6), max_new_tokens=12)
    doomed = [GenRequest(rid=1 + i, prompt=np.arange(1, 6),
                         max_new_tokens=8, priority="batch",
                         deadline_ticks=2) for i in range(3)]
    router.submit([hog] + doomed)
    router.run(max_ticks=2000)
    assert hog.state == "done"
    assert all(r.state == "shed" and r.finish_reason == "deadline"
               for r in doomed)
    assert sum(router._outstanding.values()) == 0
    post = GenRequest(rid=50, prompt=np.arange(1, 6), max_new_tokens=4)
    router.submit(post)
    router.run(max_ticks=2000)
    assert post.state == "done"
    assert sum(router._outstanding.values()) == 0


def test_fabric_ledger_conserved_through_churn(rt):
    router = _fabric(rt, pods=1, min_pods=1, max_pods=3,
                     scale_up_tokens=30, scale_idle_ticks=4)
    reqs = _requests(16)
    router.submit(reqs)
    _kill_mid_decode(router)
    _drain(router)
    assert all(r.state == "done" for r in reqs)
    assert router.outstanding_total == 0
    for _ in range(20):          # idle through drains + retires
        router.step()
    assert router.outstanding_total == 0
    assert len(router.members) >= router.min_pods
    router.close()


# ---------------------------------------------------------------------------
# the same fleets in both packages
# ---------------------------------------------------------------------------

def _kill_arm(runtime, Router, spawner, R, closure_of, pod_kwargs):
    """fig12's arm B: 2 pods, a deterministic kill mid-decode."""
    spawn = spawner(runtime, runtime.pull("stable"), pod_kwargs=pod_kwargs)
    router = Router(spawn, runtime=runtime, pods=2, min_pods=2,
                    fleet="kill")
    reqs = _fig12_trace(12, R)
    router.submit(reqs)
    victim = _kill_mid_decode(router)
    kill_tick, inflight = router.tick, sorted(victim.assigned)
    while router.busy and router.tick < MAX_TICKS:
        router.step()
    out = {"victim": victim.pod_id, "kill_tick": kill_tick,
           "inflight": inflight, "ticks": router.tick,
           "fabric": router.status()["fabric"],
           "rerouted": sorted(r.rid for r in reqs if r.reroutes),
           "closure": closure_of(router.trace_buffers()),
           "tokens": {r.rid: list(r.tokens) for r in reqs},
           "states": sorted({r.state for r in reqs}),
           "outstanding": router.outstanding_total}
    router.close()
    return out


def _elastic_arm(runtime, Router, spawner, R, pod_kwargs):
    """fig12's arm C: a 1-3 pod fleet scaling on the token backlog."""
    spawn = spawner(runtime, runtime.pull("stable"), pod_kwargs=pod_kwargs)
    router = Router(spawn, runtime=runtime, pods=1, min_pods=1, max_pods=3,
                    scale_up_tokens=40, scale_idle_ticks=6, fleet="elastic")
    reqs = _fig12_trace(12, R)
    router.submit(reqs)
    peak = 1
    while router.busy and router.tick < MAX_TICKS:
        router.step()
        peak = max(peak, len(router.members))
    for _ in range(40):          # idle past the streak: drains + retires
        router.step()
    fab = router.status()["fabric"]
    out = {"peak": peak, "spawned": fab["spawned"],
           "retired": fab["retired"], "ticks": router.tick,
           "members": len(router.members),
           "tokens": {r.rid: list(r.tokens) for r in reqs},
           "outstanding": router.outstanding_total}
    router.close()
    return out


@pytest.mark.parametrize("arm", ["kill", "elastic"])
def test_loopback_fleet_matches_jax(rt, jrt, np_params, arm):
    port_pod = dict(PORT_POD, params=np_params)
    if arm == "kill":
        jout = _kill_arm(jrt, JFabricRouter, j_loopback_spawner, JRequest,
                         j_validate_fleet_closure, POD_KWARGS)
        tout = _kill_arm(rt, FabricRouter, loopback_spawner, GenRequest,
                         validate_fleet_closure, port_pod)
        assert jout["states"] == ["done"] and jout["inflight"]
        assert jout["fabric"]["evictions"] == 1
        assert jout["fabric"]["reroutes"] >= 1
        assert jout["closure"]["routed"] == jout["closure"]["closed"] == 12
        assert jout["closure"]["rerouted"] == len(jout["rerouted"])
    else:
        jout = _elastic_arm(jrt, JFabricRouter, j_loopback_spawner,
                            JRequest, POD_KWARGS)
        tout = _elastic_arm(rt, FabricRouter, loopback_spawner, GenRequest,
                            port_pod)
        assert jout["peak"] > 1 and jout["retired"] >= 1
    assert jout["outstanding"] == 0
    assert tout == jout


# ---------------------------------------------------------------------------
# one worker process per pod, SIGKILL mid-decode
# ---------------------------------------------------------------------------

def test_proc_fleet_survives_sigkill_without_jax(rt, tmp_path, monkeypatch):
    """Workers run ``repro_torch.orchestrator.fabric_worker`` with a
    PYTHONPATH whose first entry makes ``import jax`` and ``import repro``
    raise: they boot and serve on the port alone. A worker killed with
    SIGKILL mid-decode is evicted once, its work reroutes, no request is
    lost, the tokens equal the loopback fleet's, and the span files the
    processes wrote close."""
    poison = tmp_path / "poison"
    for name in ("jax", "repro"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable here')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(poison), os.environ.get("PYTHONPATH", "")]))

    loop = _fabric(rt, pods=2, min_pods=2, fleet="loop")
    want = _fig12_trace(12, GenRequest)
    loop.submit(want)
    _drain(loop)
    loop.close()

    prt = Runtime(tmp_path / "proc")
    prt.build(IMAGEFILE, tag="stable")
    spawn = proc_spawner(prt.root, imagefile=IMAGEFILE, pod_kwargs=PORT_POD)
    router = FabricRouter(spawn, runtime=prt, pods=2, min_pods=2,
                          wall_clock=True, heartbeat_every=2, fleet="proc")
    try:
        pids = {m.pod_id: m.transport.pid for m in router.members.values()}
        reqs = _fig12_trace(12, GenRequest)
        router.submit(reqs)
        victim = _kill_mid_decode(
            router, lambda m: os.kill(m.transport.pid, signal.SIGKILL))
        _drain(router)
        fab = router.status()["fabric"]
        assert victim.transport.proc.wait(timeout=30) == -signal.SIGKILL
    finally:
        router.close()
    assert len(set(pids.values())) == 2 and os.getpid() not in pids.values()
    assert all(r.state == "done" for r in reqs)
    assert {r.rid: list(r.tokens) for r in reqs} == \
        {r.rid: list(r.tokens) for r in want}
    assert fab["evictions"] == 1 and fab["reroutes"] >= 1
    assert fab["spawned"] == 3           # healed back to min_pods
    assert router.outstanding_total == 0
    buffers = load_fleet_spans(prt.root, fleet="proc")
    validate_span_log(buffers)
    closure = validate_fleet_closure(buffers)
    assert closure["routed"] == closure["closed"] == 12
    assert closure["rerouted"] == sum(1 for r in reqs if r.reroutes)
