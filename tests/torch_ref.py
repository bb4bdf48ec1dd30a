"""Run a test of the JAX package's own suites on both packages (not
collected; imported by name from the tests dir).

``run_both`` calls a reference test function twice:

* on the JAX package, as written, with the objects it builds recorded;
* on the port: the reference module's globals that come from ``repro``
  point at the port's objects of the same name, every ``repro.*`` module
  the body imports from resolves to its ``repro_torch`` counterpart (the
  ``monkeypatch`` it may be given patches the port's modules), the
  ``local`` platform runs on the CPU, and ``Container.init_params``
  loads the JAX package's weights for the same arch and seed (torch's RNG
  cannot replay the JAX init). A global of the reference module, or an
  import its body makes, that still reaches the JAX package fails the
  run, so a body that compares nothing still runs on the port alone.

Pod, router and container ids come from ``uuid.uuid4``, restarted from
one counter before each package's run, so the ids (and the hash rings
keyed by them) are equal. It returns the two packages' summaries of what
was built (requests, pods with their engines, spans and metrics,
schedulers, routers, page pools), which the caller compares: tokens, tick
and registry counters exactly.
"""

from __future__ import annotations

import builtins
import importlib
import itertools
import json
import sys
import types
import uuid
from contextlib import contextmanager

import jax
import numpy as np
import pytest

import repro
import repro.launch.serve
import repro.orchestrator as j_orch
import repro_torch
import repro_torch.launch.serve
import repro_torch.orchestrator as t_orch
from repro.configs import get_config as j_get_config
from repro.models import params as JP
from repro.models.transformer import Model as JModel
from repro_torch.core.container import Container
from repro_torch.dist import mesh as t_mesh

# classes whose instances a summary reads
RECORDED = ("GenRequest", "Pod", "ContinuousScheduler", "PodRouter",
            "PagePool")

# modules of the JAX package a reference body imports from
ALIASED = (
    "repro.orchestrator.obs", "repro.orchestrator.obs.metrics",
    "repro.orchestrator.obs.report", "repro.orchestrator.obs.tracing",
    "repro.orchestrator.obs.validate", "repro.orchestrator.telemetry",
    "repro.orchestrator.prefix_registry", "repro.orchestrator.page_pool",
    "repro.orchestrator.request_queue", "repro.orchestrator.scheduler",
    "repro.orchestrator.router", "repro.orchestrator.pod",
    "repro.orchestrator.deployer", "repro.cli", "repro.launch.serve",
    "repro.core.runtime", "repro.core.compile_cache", "repro.data.pipeline",
)

_INIT: dict = {}


def runtimes(root, imagefile: str, tag: str = "stable") -> dict:
    """A reference module's runtime fixture in each package, ``imagefile``
    built as ``tag``: {False: the JAX package's, True: the port's}."""
    from repro.core.runtime import Runtime as JRuntime
    from repro_torch.core.runtime import Runtime
    out = {False: JRuntime(root / "jax"), True: Runtime(root / "torch")}
    for rt in out.values():
        rt.build(imagefile, tag=tag)
    return out


def port_name(mod: str) -> str:
    return "repro_torch" + mod[len("repro"):]


def jax_init(c: Container, seed: int = 0) -> dict:
    """The JAX package's ``init_params(seed)`` for the arch of the port's
    container ``c``, as numpy (cached)."""
    arch = c.image.config()["arch"]
    key = (arch["name"], json.dumps(arch.get("overrides", {}),
                                    sort_keys=True),
           str(c.param_dtype), seed)
    if key not in _INIT:
        defs = JModel(j_get_config(arch["name"],
                                   **arch.get("overrides", {}))).param_defs()
        dtype = jax.numpy.dtype(str(c.param_dtype).replace("torch.", ""))
        tree = jax.jit(lambda k: JP.materialize(defs, k, dtype))(
            jax.random.key(seed))
        _INIT[key] = jax.tree.map(np.asarray, tree)
    return _INIT[key]


def _recording(cls, sink: list):
    """``cls`` with every instance appended to ``sink``."""
    def __init__(self, *a, **kw):
        cls.__init__(self, *a, **kw)
        sink.append(self)
    return type(cls.__name__, (cls,), {"__init__": __init__,
                                       "__module__": cls.__module__})


def _package_proxy(pkg, made: dict):
    """A copy of an orchestrator package whose RECORDED classes record."""
    proxy = types.ModuleType(pkg.__name__)
    proxy.__dict__.update(pkg.__dict__)
    for name in RECORDED:
        cls = getattr(pkg, name, None)
        if cls is not None:
            setattr(proxy, name, _recording(cls, made.setdefault(name, [])))
    return proxy


def _same_ids(mp) -> None:
    counter = itertools.count(1)
    mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter) << 96))


class _PortPatch:
    """The ``monkeypatch`` a body gets on the port: a JAX module it patches
    is patched in its port counterpart."""

    def __init__(self, mp):
        self._mp = mp

    def setattr(self, target, name, value=None, **kw):
        if isinstance(target, types.ModuleType) and \
                target.__name__.startswith("repro."):
            target = importlib.import_module(port_name(target.__name__))
        return self._mp.setattr(target, name, value, **kw)

    def __getattr__(self, name):
        # chdir, setenv, setitem, ...: not module-bound, used as they are
        return getattr(self._mp, name)


def _jax_origin(value) -> str | None:
    """The JAX package's module that ``value`` is, or that defines it (or
    its class); None for anything else."""
    if isinstance(value, types.ModuleType):
        name = value.__name__
    else:
        name = getattr(value, "__module__", None)
        if not isinstance(name, str):
            name = type(value).__module__
    return name if name == "repro" or name.startswith("repro.") else None


def _assert_on_port(ref_module) -> None:
    """No global of ``ref_module`` (modules and instances included, and no
    default argument of its functions) still comes from the JAX package."""
    leaks = []
    for gname, value in vars(ref_module).items():
        held = [value]
        if isinstance(value, types.FunctionType):
            held += list(value.__defaults__ or ())
            held += list((value.__kwdefaults__ or {}).values())
        leaks += [f"{gname}: {_jax_origin(v)}" for v in held
                  if _jax_origin(v)]
    assert not leaks, (f"{ref_module.__name__} still reaches the JAX "
                       f"package on the port: {leaks}")


def _port_imports(ref_module):
    """``__import__`` that fails an import made by ``ref_module``'s code
    (a body's own ``from repro... import``) when what it binds comes from
    the JAX package."""
    real = builtins.__import__
    home = vars(ref_module)

    def guarded(name, globals=None, locals=None, fromlist=(), level=0):
        mod = real(name, globals, locals, fromlist, level)
        if globals is home:
            got = ({n: getattr(mod, n, None) for n in fromlist} if fromlist
                   else {name: mod})
            leaks = [f"{n}: {_jax_origin(v)}" for n, v in got.items()
                     if _jax_origin(v)]
            assert not leaks, (f"{ref_module.__name__} imports from the "
                               f"JAX package on the port: {leaks}")
        return mod
    return guarded


@contextmanager
def on_package(ref_module, port: bool, made: dict):
    """Point ``ref_module``'s ``repro`` globals and the ``repro.*`` module
    names at the recorded objects of one package; yields (the recorded
    orchestrator package, the monkeypatch a body may use)."""
    mp = pytest.MonkeyPatch()
    try:
        _same_ids(mp)
        proxy = _package_proxy(t_orch if port else j_orch, made)
        mp.setitem(sys.modules, "repro.orchestrator", proxy)
        mp.setattr(repro, "orchestrator", proxy)
        # serve_continuous builds its pods, schedulers and requests through
        # its package's orchestrator; its results are recorded too
        serve_mod = importlib.import_module(
            port_name("repro.launch.serve") if port else "repro.launch.serve")
        real_serve = serve_mod.serve_continuous

        def serve_continuous(*a, **kw):
            out = real_serve(*a, **kw)
            made.setdefault("serve", []).append(out)
            return out
        mp.setattr(serve_mod, "serve_continuous", serve_continuous)
        if port:
            mp.setitem(sys.modules, "repro_torch.orchestrator", proxy)
            mp.setattr(repro_torch, "orchestrator", proxy)
            mp.setitem(t_mesh.PLATFORMS["local"], "device", "cpu")
            mp.setattr(Container, "init_params",
                       lambda self, seed=0: self.load_params(
                           jax_init(self, seed)))
            for name in ALIASED:
                mod = importlib.import_module(port_name(name))
                mp.setitem(sys.modules, name, mod)
                parent, _, child = name.rpartition(".")
                owner = (proxy if parent == "repro.orchestrator"
                         else importlib.import_module(parent))
                mp.setattr(owner, child, mod, raising=False)
        for gname, value in list(vars(ref_module).items()):
            mod = getattr(value, "__module__", None) or ""
            if not callable(value) or not mod.startswith("repro."):
                continue
            name = getattr(value, "__name__", gname)
            if name in RECORDED:
                mp.setattr(ref_module, gname, getattr(proxy, name))
            elif port:
                src = importlib.import_module(port_name(mod))
                mp.setattr(ref_module, gname, getattr(src, name))
        if port:
            _assert_on_port(ref_module)
            mp.setattr(builtins, "__import__", _port_imports(ref_module))
        yield proxy, (_PortPatch(mp) if port else mp)
    finally:
        mp.undo()


def run_on(ref_module, fn, port: bool, args=None, kwargs=None,
           needs_monkeypatch: bool = False) -> dict:
    """Call ``fn`` on one package; returns the recorded objects by class
    name. ``args(pkg, port)`` builds the positional arguments (the
    reference fixtures' values) inside the package's context, from the
    recorded orchestrator package ``pkg``."""
    made: dict = {}
    with on_package(ref_module, port, made) as (pkg, mp):
        kw = dict(kwargs or {})
        if needs_monkeypatch:
            kw["monkeypatch"] = mp
        fn(*(args(pkg, port) if args else ()), **kw)
    return made


def run_both(ref_module, name: str, args=None, **kwargs):
    """``ref_module.name`` on the JAX package, then on the port; returns
    (JAX summary, port summary)."""
    fn = getattr(ref_module, name)
    jmade = run_on(ref_module, fn, False, args, **kwargs)
    tmade = run_on(ref_module, fn, True, args, **kwargs)
    return summary(jmade), summary(tmade)


def check_both(ref_module, name: str, args=None, **kwargs) -> dict:
    """``run_both``, then every section of the summaries equal; returns
    the port's summary."""
    j, t = run_both(ref_module, name, args, **kwargs)
    assert_same(j, t)
    return t


# ---------------------------------------------------------------------------
# summaries: what two runs of one body must agree on
# ---------------------------------------------------------------------------

REQUEST_FIELDS = ("rid", "state", "finish_reason", "error", "submit_tick",
                  "admit_tick", "done_tick", "replica", "slot", "pod",
                  "preemptions", "priority", "spilled", "reroutes")
# host-clock (or process) numbers of a serve_continuous result: not
# compared
SERVE_CLOCKED = ("wall_s", "decode_s", "prefill_s", "decode_tok_per_s",
                 "pod", "fleet")
ENGINE_COUNTERS = ("slots_allocated", "slots_freed", "decode_ticks",
                   "tokens_generated", "prefill_positions", "prefix_hits",
                   "prefix_misses", "prefix_tokens_saved", "preemptions",
                   "resumes", "tokens_wasted")


def request_summary(r) -> dict:
    out = {k: getattr(r, k, None) for k in REQUEST_FIELDS}
    out["tokens"] = [int(t) for t in r.tokens]
    return out


def pool_summary(p) -> dict:
    return {"table": p.table.tolist(), "refcount": p.refcount.tolist(),
            "free": sorted(int(x) for x in p.free),
            "reserved": p.reserved.tolist(), "status": p.status()}


def engine_summary(e) -> dict:
    out = {k: getattr(e, k) for k in ENGINE_COUNTERS}
    out.update(name=e.name, free=sorted(e.free), pos=list(map(int, e.pos)),
               stopped=e.stopped, draining=e.draining)
    if getattr(e, "pool", None) is not None:
        out["pool"] = pool_summary(e.pool)
    return out


def pod_summary(p) -> dict:
    return {"pod": p.pod_id, "rejected": p.rejected, "shed": p.shed,
            "engines": [engine_summary(e) for e in p.engines],
            "retired": [engine_summary(e) for e in p.retired],
            "metrics": p.metrics.snapshot(),
            "spans": [(e.rid, e.name, e.tick) for e in p.trace.events()]}


def summary(made: dict) -> dict:
    return {
        "requests": [request_summary(r) for r in made.get("GenRequest", [])],
        "pods": [pod_summary(p) for p in made.get("Pod", [])],
        "schedulers": [{"tick": s.tick,
                        "admission_order": list(s.admission_order),
                        "rejected": [r.rid for r in s.rejected],
                        "shed": [r.rid for r in s.shedded]}
                       for s in made.get("ContinuousScheduler", [])],
        "routers": [{k: r.status()[k] for k in
                     ("policy", "pods", "routed", "spilled", "completed",
                      "rejected", "shed", "by_policy", "metrics")}
                    for r in made.get("PodRouter", [])],
        "pools": [pool_summary(p) for p in made.get("PagePool", [])],
        "serves": [{k: v for k, v in out.items() if k not in SERVE_CLOCKED}
                   for out in made.get("serve", [])],
    }


def assert_same(j: dict, t: dict) -> None:
    """Every section equal; the first differing entry is named."""
    for key in j:
        assert len(j[key]) == len(t[key]), (key, len(j[key]), len(t[key]))
        for i, (a, b) in enumerate(zip(j[key], t[key])):
            assert a == b, (key, i, _first_diff(a, b))


def _first_diff(a, b, path=""):
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if a.get(k) != b.get(k):
                return _first_diff(a.get(k), b.get(k), f"{path}.{k}")
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_diff(x, y, f"{path}[{i}]")
    return path, a, b
