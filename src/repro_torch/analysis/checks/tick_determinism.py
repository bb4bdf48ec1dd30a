"""tick-determinism: scheduler/router step paths are clockless and
ordered.

The acceptance test for the observability layer recomputes the whole
metrics registry from the trace buffers and requires a *bitwise* match
with the live registry. That only holds because the orchestrator is
clocked in ticks: admission, routing, preemption and completion are pure
functions of (tick, queue contents, pool state). Wall-clock reads,
``random`` draws and unordered-``set`` iteration in those paths make two
runs (or the live run and its recompute) diverge.

Scope: files named like orchestrator step modules (``scheduler.py``,
``router.py``, ``request_queue.py``, ``pod.py``, ``page_pool.py``,
``prefix_registry.py`` -- the pool's eviction order and the radix walk
feed admission decisions, so they are step paths too), every function
except ``__init__`` (construction may seed ids and wall-clock offsets; steps
may not). Allowed escape hatch: ``time.perf_counter()`` assigned to a
``t0``-style local or accumulated into a ``*_s`` attribute -- that is
the sanctioned *reporting-only* duration pattern (never fed back into
scheduling decisions).
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.core import Check, Finding

SCOPE_BASENAMES = {"scheduler.py", "router.py", "request_queue.py",
                   "pod.py", "page_pool.py", "prefix_registry.py"}

_BANNED_CALLS = {
    "time.time", "time.monotonic", "time.monotonic_ns", "time.time_ns",
    "time.localtime", "time.ctime",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today", "date.today",
    "uuid.uuid1", "uuid.uuid4",
}
_BANNED_PREFIXES = ("random.", "np.random.", "numpy.random.")
_ALLOWED_RANDOM = {"np.random.default_rng", "numpy.random.default_rng"}
_TIMER_LOCAL_RE = re.compile(r"^t\d*$")


def _in_scope(rel: str) -> bool:
    return rel.replace("\\", "/").rsplit("/", 1)[-1] in SCOPE_BASENAMES


class TickDeterminismCheck(Check):
    rule = "tick-determinism"
    description = ("no wall-clock, random draws or unordered-set "
                   "iteration in scheduler/router step paths")

    def run(self, project):
        for f in project.files:
            if f.tree is None or not _in_scope(f.rel):
                continue
            set_attrs = self._set_attrs(f.tree)
            for fn in ast.walk(f.tree):
                if isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) and \
                        fn.name != "__init__":
                    yield from self._check_function(f, fn, set_attrs)

    @staticmethod
    def _set_attrs(tree: ast.Module) -> set[str]:
        """self-attributes initialised to a set in any __init__ in this
        file (e.g. the router's drain list) -- iterating them raw is
        order-nondeterministic."""
        out = set()
        for fn in ast.walk(tree):
            if not (isinstance(fn, ast.FunctionDef) and
                    fn.name == "__init__"):
                continue
            for node in ast.walk(fn):
                target = value = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target, value = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign):
                    target, value = node.target, node.value
                if not (isinstance(target, ast.Attribute) and
                        isinstance(target.value, ast.Name) and
                        target.value.id == "self"):
                    continue
                if isinstance(value, (ast.Set, ast.SetComp)) or (
                        isinstance(value, ast.Call) and
                        isinstance(value.func, ast.Name) and
                        value.func.id in ("set", "frozenset")):
                    out.add(target.attr)
        return out

    def _check_function(self, f, fn, set_attrs):
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.stmt):
                yield from self._check_calls(f, stmt)
        for node in ast.walk(fn):
            if isinstance(node, ast.For):
                yield from self._check_iter(f, node.iter, set_attrs)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                for comp in node.generators:
                    yield from self._check_iter(f, comp.iter, set_attrs)

    # -- clock & randomness ---------------------------------------------------
    def _check_calls(self, f, stmt: ast.stmt):
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.stmt):
                continue        # nested statements get their own pass
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                name = self.unparse(call.func)
                if name == "time.perf_counter":
                    if not self._sanctioned_timer(stmt):
                        yield Finding(
                            rule=self.rule, file=f.rel, line=call.lineno,
                            message="time.perf_counter() outside the "
                                    "reporting-only duration pattern",
                            hint="wall time may only be measured into a "
                                 "tN local or accumulated into a *_s "
                                 "attribute, never fed into scheduling "
                                 "decisions")
                    continue
                if name in _BANNED_CALLS:
                    yield Finding(
                        rule=self.rule, file=f.rel, line=call.lineno,
                        message=f"nondeterministic call {name}() in a "
                                "step path",
                        hint="the orchestrator is tick-clocked; derive "
                             "what you need from the tick counter or do "
                             "it in __init__")
                elif name.startswith(_BANNED_PREFIXES) and \
                        name not in _ALLOWED_RANDOM:
                    yield Finding(
                        rule=self.rule, file=f.rel, line=call.lineno,
                        message=f"unseeded random draw {name}() in a "
                                "step path",
                        hint="use a generator seeded in __init__ "
                             "(np.random.default_rng(seed)) so replays "
                             "are bitwise-identical")

    @staticmethod
    def _sanctioned_timer(stmt: ast.stmt) -> bool:
        """``t0 = time.perf_counter()`` or
        ``self.x_s += time.perf_counter() - t0``."""
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                _TIMER_LOCAL_RE.match(stmt.targets[0].id):
            return True
        if isinstance(stmt, ast.AugAssign):
            t = stmt.target
            if isinstance(t, ast.Attribute) and t.attr.endswith("_s"):
                return True
            if isinstance(t, ast.Name) and t.id.endswith("_s"):
                return True
        return False

    # -- unordered iteration --------------------------------------------------
    def _check_iter(self, f, it: ast.expr, set_attrs):
        unordered = None
        if isinstance(it, (ast.Set, ast.SetComp)):
            unordered = "a set literal"
        elif isinstance(it, ast.Call) and \
                isinstance(it.func, ast.Name) and \
                it.func.id in ("set", "frozenset"):
            unordered = f"{it.func.id}(...)"
        elif isinstance(it, ast.Attribute) and it.attr in set_attrs:
            unordered = f"set attribute '{self.unparse(it)}'"
        if unordered:
            yield Finding(
                rule=self.rule, file=f.rel, line=it.lineno,
                message=f"iteration over {unordered} in a step path is "
                        "order-nondeterministic",
                hint="wrap it in sorted(...) -- tie-break order decides "
                     "which request is admitted/preempted first")
