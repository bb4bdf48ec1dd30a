"""jit-capture: closures handed to jax.jit must be pure of orchestrator
state.

``jax.jit`` traces its callable once per input signature; anything the
callable *closes over* is baked into the trace. Capturing per-tick
mutable orchestrator state (``self.pos``, ``self.cur_tok``, the page
table, the pool object...) produces either a stale snapshot (the jitted
step keeps using tick-0 values) or a silent retrace storm when jax
treats the captured value as a new constant each call. The data must
flow through the traced *arguments* instead.

Second hazard: ``static_argnums`` requires hashable values -- calling a
jitted function with a list/dict/set display at a static position raises
at runtime (or worse, retraces per call once someone "fixes" it by
tupling inconsistently). We flag display literals at statically-declared
positions.

In the port this rule is a copy of the reference's: its contract is about
``jax.jit``, so on ``src/repro_torch`` it finds nothing by construction,
and it gives the reference's findings on any JAX source it is pointed at.
The port's analog (closures held by ``CompileCache`` and tensors a graph
captures) waits for captured CUDA-graph decode, where capture starts to
matter.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import Check, Finding

# per-tick mutable orchestrator attributes: scheduler slot state, pool
# bookkeeping, queue contents. Capturing any of these in a jitted closure
# snapshots one tick forever.
MUTABLE_STATE = {"pos", "cur_tok", "active", "free", "cache", "tick",
                 "queue", "paused", "table", "reserved", "owned",
                 "shared", "prefix", "pool"}

_DISPLAYS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
             ast.SetComp)


def _jit_call(node: ast.AST) -> ast.Call | None:
    if isinstance(node, ast.Call) and \
            Check.unparse(node.func) in ("jax.jit", "jit"):
        return node
    return None


def _static_positions(call: ast.Call) -> tuple[int, ...]:
    arg = Check.call_kwarg(call, "static_argnums")
    if isinstance(arg, ast.Constant) and isinstance(arg.value, int):
        return (arg.value,)
    if isinstance(arg, (ast.Tuple, ast.List)):
        return tuple(e.value for e in arg.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, int))
    return ()


class JitCaptureCheck(Check):
    rule = "jit-capture"
    description = ("jitted closures must not capture per-tick mutable "
                   "state; static_argnums positions must get hashable "
                   "values")

    def run(self, project):
        for f in project.files:
            if f.tree is None:
                continue
            yield from self._check_file(f)

    def _check_file(self, f):
        # function-local defs, for resolving jax.jit(local_fn)
        local_defs: dict[int, dict[str, ast.FunctionDef]] = {}
        for fn in ast.walk(f.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local_defs[id(fn)] = {
                    sub.name: sub for sub in ast.walk(fn)
                    if isinstance(sub, ast.FunctionDef) and sub is not fn}
        # static_argnums bookkeeping: jitted name -> static positions
        statics: dict[str, tuple[int, ...]] = {}
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                jc = _jit_call(node.value)
                if jc is not None:
                    pos = _static_positions(jc)
                    if pos:
                        statics[node.targets[0].id] = pos
            jc = _jit_call(node)
            if jc is None:
                continue
            yield from self._check_capture(f, jc, local_defs)
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            pos: tuple[int, ...] = ()
            inner = _jit_call(node.func)
            if inner is not None:            # jax.jit(f, ...)(args)
                pos = _static_positions(inner)
            elif isinstance(node.func, ast.Name):
                pos = statics.get(node.func.id, ())
            for p in pos:
                if p < len(node.args) and \
                        isinstance(node.args[p], _DISPLAYS):
                    yield Finding(
                        rule=self.rule, file=f.rel, line=node.lineno,
                        message=f"unhashable "
                                f"{type(node.args[p]).__name__.lower()} "
                                f"literal at static_argnums position {p}",
                        hint="static args are hashed for the trace "
                             "cache; pass a tuple (or hoist the value "
                             "into the closure if it is constant)")

    def _check_capture(self, f, jit: ast.Call, local_defs):
        target = jit.args[0] if jit.args else \
            self.call_kwarg(jit, "fun")
        bodies: list[ast.AST] = []
        if isinstance(target, ast.Lambda):
            bodies = [target.body]
        elif isinstance(target, ast.Name):
            # a locally-defined closure (module-level functions take
            # their state as arguments by construction)
            for defs in local_defs.values():
                fn = defs.get(target.id)
                if fn is not None:
                    bodies = list(fn.body)
                    break
        for body in bodies:
            for node in ast.walk(body):
                if isinstance(node, ast.Attribute) and \
                        isinstance(node.ctx, ast.Load) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id == "self" and \
                        node.attr in MUTABLE_STATE:
                    yield Finding(
                        rule=self.rule, file=f.rel, line=node.lineno,
                        message=f"jitted closure captures per-tick "
                                f"mutable state 'self.{node.attr}'",
                        hint="pass it as a traced argument to the "
                             "jitted function; captured state is "
                             "snapshotted at trace time and never "
                             "updates")
