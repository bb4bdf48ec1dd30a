"""The port's entry points against the JAX package's, on the CPU, on
llama3.2-3b-smoke with the JAX package's weights handed over as numpy.

* ``launch/serve.main`` (one pod, and two pods behind a ``PodRouter``
  under each placement policy) gives the same per-request tokens, latency
  summary, TTFT/ITL decomposition, prefix hits and per-pod placement in
  both packages. Pod, router and container ids come from ``uuid.uuid4``,
  which the tests replace with one counter restarted for each package, so
  the consistent-hash ring (keyed by pod id) is the same in both;
* static mode gives the same tokens as continuous mode on the port;
* ``RollingDeployer`` reports for a pod and for a router fleet equal the
  JAX package's;
* the CLI prints the same image digests and layers in both packages, and
  the port's ``ps``/``top`` read the state files its ``serve`` wrote;
* the obs validator accepts the exported trace;
* ``serve --fabric loopback`` gives the JAX package's tokens, reroutes,
  evictions, sheds, rejects and latency ticks; ``serve --fabric proc``
  runs one worker process per pod and ``validate --spans`` accepts the
  span files they wrote;
* ``lint`` runs the port's linter, with and without ``--root``, and
  builds no Runtime.

The port's ``Container.init_params`` is patched to load the JAX package's
seed-0 weights (torch's RNG cannot replay the JAX init), so both packages
serve the same model. Greedy tokens are compared for equality, tick-clocked
numbers exactly.
"""

import contextlib
import io
import itertools
import uuid

import jax
import numpy as np
import pytest

import repro.launch.serve as jserve
import repro_torch.launch.serve as tserve
from repro.cli import main as jcli
from repro.core.runtime import Runtime as JRuntime
from repro.orchestrator import ContinuousScheduler as JScheduler
from repro.orchestrator import GenRequest as JRequest
from repro.orchestrator import Pod as JPod
from repro.orchestrator import PodRouter as JRouter
from repro.orchestrator import RollingDeployer as JDeployer
from repro_torch.cli import main as tcli
from repro_torch.core.container import Container
from repro_torch.core.runtime import Runtime
from repro_torch.orchestrator import (ContinuousScheduler, GenRequest, Pod,
                                      PodRouter, RollingDeployer)
from repro_torch.orchestrator.obs import validate as tvalidate

pytestmark = pytest.mark.orchestrator

IMAGEFILE = """
FROM scratch
ARCH llama3.2-3b-smoke
SHAPE decode_32k seq_len=64 global_batch=4
MESH local
PRECISION compute=float32 params=float32
COLLECTIVES generic
"""

# a small paged trace with a shared 12-token system prompt: prefix hits,
# staggered arrivals, heavy-tailed budgets
SERVE = ["--image", "stable", "--replicas", "1", "--slots", "3",
         "--requests", "10", "--prompt-len", "20", "--gen", "8",
         "--arrive-per-tick", "4", "--paged", "--page-size", "8",
         "--prefix-cache", "--shared-prefix", "12"]


@pytest.fixture(scope="module")
def np_params(tmp_path_factory):
    jrt = JRuntime(tmp_path_factory.mktemp("jax-init"))
    jrt.build(IMAGEFILE, tag="stable")
    return jax.tree.map(np.asarray, jrt.run("stable").init_params(0))


@pytest.fixture
def same_ids(monkeypatch):
    """``restart()`` makes the next ``uuid.uuid4`` calls return the same
    sequence again (ids distinct in their first 8 hex digits)."""
    counter = [itertools.count(1)]
    monkeypatch.setattr(
        uuid, "uuid4", lambda: uuid.UUID(int=next(counter[0]) << 96))

    def restart():
        counter[0] = itertools.count(1)
    return restart


@pytest.fixture
def jax_weights(monkeypatch, np_params):
    """The port's containers serve the JAX package's seed-0 weights."""
    monkeypatch.setattr(Container, "init_params",
                        lambda self, seed=0: self.load_params(np_params))


def _roots(path):
    jrt, trt = JRuntime(path / "jax"), Runtime(path / "torch")
    jrt.build(IMAGEFILE, tag="stable")
    trt.build(IMAGEFILE, tag="stable")
    return jrt, trt


@pytest.fixture
def roots(tmp_path):
    return _roots(tmp_path)


@pytest.fixture(scope="module")
def serve_roots(tmp_path_factory):
    """Shared by the serve runs: the JAX package's on-disk compile cache
    under the root warms once."""
    return _roots(tmp_path_factory.mktemp("serve"))


def _serve(mod, root, argv, monkeypatch, platform=None):
    """``mod.main`` on ``argv``; returns (output, {rid: pod id})."""
    built = []
    real = mod._build_requests

    def record(*a, **k):
        reqs = real(*a, **k)
        built.extend(reqs)
        return reqs
    monkeypatch.setattr(mod, "_build_requests", record)
    extra = ["--platform", platform] if platform else []
    with contextlib.redirect_stdout(io.StringIO()):
        out = mod.main([*argv, "--root", str(root), *extra])
    return out, {r.rid: r.pod for r in built}


@pytest.mark.parametrize("pods,policy", [
    (1, "shortest-queue"), (2, "shortest-queue"), (2, "consistent-hash"),
    (2, "prefix-hash")], ids=["one-pod", "shortest-queue", "consistent-hash",
                              "prefix-hash"])
def test_serve_main_matches_jax(serve_roots, monkeypatch, same_ids,
                                jax_weights, pods, policy):
    jrt, trt = serve_roots
    argv = SERVE + ["--pods", str(pods), "--policy", policy]
    same_ids()
    jout, jplace = _serve(jserve, jrt.root, argv, monkeypatch)
    same_ids()
    tout, tplace = _serve(tserve, trt.root, argv, monkeypatch, "cpu")
    assert tout["requests"] == jout["requests"] == 10
    assert tout["request_tokens"] == jout["request_tokens"]
    for k in ("latency_count", "p50_latency_ticks", "p99_latency_ticks",
              "decode_ticks", "prefill_positions", "tokens",
              "tokens_wasted", "prefix_cache", "decomposition"):
        assert tout[k] == jout[k], k
    assert tout["prefix_cache"]["hits"] > 0
    assert tplace == jplace
    if pods > 1:
        # the trace is one prefix family: prefix-hash keeps it on one pod,
        # the other policies spread it
        assert len(set(tplace.values())) == (1 if policy == "prefix-hash"
                                             else 2)
        tf, jf = tout["fleet"], jout["fleet"]
        for k in ("pods", "routed", "spilled", "completed", "by_policy",
                  "metrics"):
            assert tf[k] == jf[k], k
        assert [m["pod"] for m in tf["members"]] == \
            [m["pod"] for m in jf["members"]]


def test_static_equals_continuous_on_the_port(tmp_path, monkeypatch,
                                              jax_weights):
    rt = Runtime(tmp_path / "rt")
    rt.build(IMAGEFILE, tag="stable")
    argv = ["--image", "stable", "--replicas", "1", "--slots", "4",
            "--requests", "9", "--prompt-len", "16", "--gen", "8"]
    cont, _ = _serve(tserve, rt.root, argv, monkeypatch, "cpu")
    static, _ = _serve(tserve, rt.root, argv + ["--mode", "static"],
                       monkeypatch, "cpu")
    assert static["mode"] == "static" and static["requests"] == 9
    assert static["request_tokens"] == cont["request_tokens"]
    assert static["tokens"] == cont["tokens"]


def test_generate_step_matches_jax(tmp_path, jax_weights, np_params):
    """The port's ``generate`` serve step (per-row starts) gives the JAX
    step's tokens after the same wave prefill."""
    import jax.numpy as jnp
    import torch
    jrt, trt = JRuntime(tmp_path / "j"), Runtime(tmp_path / "t")
    jrt.build(IMAGEFILE, tag="stable")
    trt.build(IMAGEFILE, tag="stable")
    jc, tc = jrt.run("stable"), trt.run("stable", platform="cpu")
    B, P, G = 3, 12, 6
    shapes = dict(batch=B, prompt_len=P, cache_len=P + G + 1)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (B, P)).astype(np.int32)
    lens = np.array([12, 5, 9], np.int32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jfirst, jcache = jc.compile_serve_step("prefill_slot", **shapes)(
        jparams, jnp.asarray(toks), jnp.asarray(lens))
    jgen, _ = jc.compile_serve_step(
        "generate", batch=B, cache_len=P + G + 1, gen_steps=G,
        per_row=True)(jparams, jcache, jfirst[:, None], jnp.asarray(lens))
    tparams = tc.init_params(0)
    tfirst, tcache = tc.compile_serve_step("prefill_slot", **shapes)(
        tparams, torch.from_numpy(toks), torch.from_numpy(lens))
    tgen, _ = tc.compile_serve_step(
        "generate", batch=B, cache_len=P + G + 1, gen_steps=G,
        per_row=True)(tparams, tcache, tfirst[:, None],
                      torch.from_numpy(lens))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))
    assert tgen.shape == (B, G)
    # the per_row flag fixes the start's rank
    for per_row, start in ((True, 4), (False, torch.from_numpy(lens))):
        with pytest.raises(ValueError, match="start_idx of shape"):
            tc.compile_serve_step(
                "generate", batch=B, cache_len=P + G + 1, gen_steps=G,
                per_row=per_row)(tparams, tcache, tfirst[:, None], start)


def _retag(rt):
    rt.build(IMAGEFILE + "LABEL release=r2\n", tag="stable")


def test_pod_upgrade_report_matches_jax(roots, same_ids, jax_weights):
    """tests/test_orchestrator.py:177 on both packages: the same report
    (digests, containers, in-flight counts, drain ticks), the same
    tokens."""
    reports, tokens = [], []
    for rt, P, S, R, D in zip(roots, (JPod, Pod), (JScheduler,
                                                   ContinuousScheduler),
                              (JRequest, GenRequest),
                              (JDeployer, RollingDeployer)):
        same_ids()
        pod = P(rt, "stable", replicas=2, n_slots=2, max_len=56,
                platform=None if rt is roots[0] else "cpu")
        sched = S(pod, fairness_cap=4)
        reqs = [R(rid=i, prompt=np.arange(4), max_new_tokens=30)
                for i in range(4)]
        sched.submit(reqs)
        sched.step()
        _retag(rt)
        reports.append(D(pod, sched).upgrade())
        sched.run(max_ticks=1000)
        assert all(r.state == "done" and len(r.tokens) == 30 for r in reqs)
        tokens.append([list(r.tokens) for r in reqs])
    assert reports[0]["changed"] and len(reports[0]["replicas"]) == 2
    assert reports[1] == reports[0]
    assert tokens[1] == tokens[0]


def test_fleet_upgrade_report_matches_jax(roots, same_ids, jax_weights):
    """tests/test_router.py:241 on both packages: the fleet roll's report
    (per-pod records, capacity floor) and tokens are the same."""
    reports, tokens = [], []
    for rt, P, Rt, R, D in zip(roots, (JPod, Pod), (JRouter, PodRouter),
                               (JRequest, GenRequest),
                               (JDeployer, RollingDeployer)):
        same_ids()
        kw = {} if rt is roots[0] else {"platform": "cpu"}
        pods = [P(rt, "stable", replicas=1, n_slots=2, max_len=56, **kw)
                for _ in range(3)]
        router = Rt(pods)
        reqs = [R(rid=i, prompt=np.arange(1, 5), max_new_tokens=24)
                for i in range(9)]
        router.submit(reqs)
        router.step()
        _retag(rt)
        rep = D(router).upgrade()
        router.run(max_ticks=5000)
        assert all(r.state == "done" and len(r.tokens) == 24 for r in reqs)
        reports.append(rep)
        tokens.append([list(r.tokens) for r in reqs])
    assert reports[0]["changed"] and len(reports[0]["pods"]) == 3
    assert reports[0]["capacity_floor"] >= 2 * 2
    assert reports[1] == reports[0]
    assert tokens[1] == tokens[0]


def _cli(main, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(list(argv)) == 0
    return buf.getvalue()


def test_cli_image_commands_print_the_same(tmp_path):
    imagefile = tmp_path / "Imagefile"
    imagefile.write_text(IMAGEFILE)
    outs = []
    for main, name in ((jcli, "jax"), (tcli, "torch")):
        root = str(tmp_path / name)
        outs.append([_cli(main, "--root", root, "build", "-t", "stable",
                          str(imagefile)),
                     _cli(main, "--root", root, "images"),
                     _cli(main, "--root", root, "history", "stable"),
                     _cli(main, "--root", root, "inspect", "stable"),
                     _cli(main, "--root", root, "tag", "stable", "prod")])
    assert outs[1] == outs[0]
    assert "stable" in outs[1][1] and "llama3.2-3b-smoke" in outs[1][3]


def test_ps_top_and_validate_read_what_serve_wrote(tmp_path, monkeypatch):
    rt = Runtime(tmp_path / "rt")
    rt.build(IMAGEFILE, tag="stable")
    root = str(rt.root)
    trace = tmp_path / "t.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["--root", root, "serve", "stable", "--platform", "cpu",
                     "--pods", "2", "--replicas", "1", "--slots", "2",
                     "--requests", "6", "--prompt-len", "12", "--gen", "4",
                     "--trace", str(trace)]) == 0
    ps = _cli(tcli, "--root", root, "ps")
    routers = [ln for ln in ps.splitlines() if ln.startswith("router-")]
    pods = [ln for ln in ps.splitlines() if ln.startswith("pod-")]
    assert len(routers) == 1 and "policy=shortest-queue pods=2" in routers[0]
    assert len(pods) == 2 and all("exited" in ln for ln in pods)
    top = _cli(tcli, "--root", root, "top").splitlines()
    assert top[0].split()[:3] == ["NAME", "PHASE", "LIVE"]
    assert len(top) == 4           # header, the router, two pods
    assert _cli(tvalidate.main, str(trace)).startswith(f"OK {trace}")
    trace.write_text('{"traceEvents": [{"ph": "X"}]}')
    with contextlib.redirect_stderr(io.StringIO()):
        assert tvalidate.main([str(trace)]) == 1


# serve --fabric with every fleet flag: two pods of two slots whose token
# backlog spawns a third (kills are tests/test_torch_fabric.py's)
FABRIC = ["--image", "stable", "--pods", "2", "--replicas", "1", "--slots",
          "2", "--requests", "10", "--prompt-len", "12", "--gen", "8",
          "--arrive-per-tick", "4", "--paged", "--page-size", "8",
          "--min-pods", "2", "--max-pods", "3", "--heartbeat-every", "2",
          "--scale-up-tokens", "4", "--scale-idle-ticks", "3"]


def test_serve_fabric_loopback_matches_jax(serve_roots, monkeypatch,
                                           same_ids, jax_weights):
    jrt, trt = serve_roots
    same_ids()
    jout, jplace = _serve(jserve, jrt.root, FABRIC + ["--fabric",
                                                      "loopback"],
                          monkeypatch)
    same_ids()
    tout, tplace = _serve(tserve, trt.root, FABRIC + ["--fabric",
                                                      "loopback"],
                          monkeypatch, "cpu")
    assert tout["mode"] == "fabric" and tout["requests"] == 10
    for k in ("request_tokens", "reroutes", "evictions", "shed",
              "rejected", "latency_count", "p50_latency_ticks",
              "p99_latency_ticks", "tokens", "fleet_closure",
              "decomposition"):
        assert tout[k] == jout[k], k
    assert tplace == jplace
    tf, jf = tout["fleet"]["fabric"], jout["fleet"]["fabric"]
    assert tf == jf and tf["spawned"] == 3      # the backlog scaled up


def test_serve_fabric_proc_then_validate_spans(tmp_path):
    rt = Runtime(tmp_path / "rt")
    rt.build(IMAGEFILE, tag="stable")
    root = str(rt.root)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli(["--root", root, "serve", "stable", "--platform", "cpu",
                     "--pods", "2", "--replicas", "1", "--slots", "2",
                     "--requests", "6", "--prompt-len", "12", "--gen", "4",
                     "--fabric", "proc", "--min-pods", "2"]) == 0
    ps = _cli(tcli, "--root", root, "ps")
    fabric = [ln for ln in ps.splitlines() if ln.startswith("fabric-")]
    workers = [ln for ln in ps.splitlines() if ln.startswith("fab-")]
    assert len(fabric) == 1 and "live=" in fabric[0]
    assert len(workers) == 2 and all("exited" in ln for ln in workers)
    out = _cli(tvalidate.main, "--spans", root)
    assert out.startswith(f"OK {root}") and "6 routed / 6 closed" in out
    with contextlib.redirect_stderr(io.StringIO()):
        assert tvalidate.main(["--spans", str(tmp_path / "empty")]) == 1


def test_lint_runs_with_and_without_root(tmp_path, monkeypatch, capsys):
    """The port's CLI runs the port's linter on the tree, clean under
    --strict, directly and after ``--root X``, and neither form creates a
    runtime root."""
    from pathlib import Path
    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    root = tmp_path / "rt"
    assert tcli(["lint", "--strict", "src"]) == 0
    # after --root, argparse takes the first word after `lint` as the
    # start of the forwarded arguments only if it is not a flag (as in
    # the JAX package's CLI), so the paths come first
    assert tcli(["--root", str(root), "lint", "src", "tests", "--strict",
                 "--ratchet", "lint-ratchet.json"]) == 0
    out = capsys.readouterr().out
    assert out.count("repro lint: 0 error(s), 0 warning(s)") == 2
    assert not root.exists()
