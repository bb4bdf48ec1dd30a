"""donation: jax buffer-donation discipline.

``jax.jit(..., donate_argnums=...)`` invalidates the donated Python
reference the moment the jitted callable runs -- the buffer is aliased to
an output and may be overwritten in place. Reading the old reference
afterwards is undefined behaviour that XLA only sometimes reports. The
serving hot path leans on donation everywhere (``SlotEngine.decode``
donates the KV cache, the module-level ``_insert_*_jit`` scatters donate
the bank), so the rule is:

* after a call to a donating callable, the donated argument expression
  must not be read again until it is re-assigned (the canonical shape is
  ``self.cache = donating(self.cache, ...)`` -- donation and re-bind in
  one statement);
* a ``jax.jit`` whose ``donate_argnums`` points at the live prefix-page
  pool must not exist: the prefix-prefill path reads cached pages straight
  out of the pool, so the pool argument stays undonated
  (see ``Container.lower_serve_step``, the ``pfx`` branch).

In the port this rule is a copy of the reference's: its contract is about
``jax.jit``, so on ``src/repro_torch`` it finds nothing by construction,
and it gives the reference's findings on any JAX source it is pointed at.
The port's analog (buffers a captured graph reuses across replays) waits
for captured CUDA-graph decode, where capture starts to matter.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.core import Check, Finding

_POOL_RE = re.compile(r"\bpool\b", re.IGNORECASE)


def _jit_call(node: ast.AST) -> ast.Call | None:
    if isinstance(node, ast.Call) and \
            Check.unparse(node.func) in ("jax.jit", "jit"):
        return node
    return None


def _donate_positions(call: ast.Call) -> tuple[int, ...]:
    """Literal donate_argnums positions of a jax.jit call; () when absent
    or unresolvable. An ``(1,) if donate else ()`` IfExp resolves to the
    donating branch -- the hazard exists whenever donation is possible."""
    arg = Check.call_kwarg(call, "donate_argnums")
    if isinstance(arg, ast.IfExp):
        for branch in (arg.body, arg.orelse):
            pos = _literal_positions(branch)
            if pos:
                return pos
        return ()
    return _literal_positions(arg)


def _literal_positions(node: ast.AST | None) -> tuple[int, ...]:
    if node is None:
        return ()
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                out.append(e.value)
        return tuple(out)
    return ()


def _walk_stmt(stmt: ast.stmt):
    """Every expression node of one statement, not descending into nested
    function/class/lambda bodies (their execution is deferred)."""
    todo = [stmt]
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            todo.append(child)


def _store_targets(stmt: ast.stmt) -> list[str]:
    """Expressions re-bound by this statement (clearing a pending
    donation). Subscript stores do NOT clear -- ``x[0] = v`` still reads
    the donated buffer ``x``."""
    out = []

    def tgt(node):
        if isinstance(node, (ast.Name, ast.Attribute)):
            out.append(Check.unparse(node))
        elif isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                tgt(e)
        elif isinstance(node, ast.Starred):
            tgt(node.value)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            tgt(t)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        tgt(stmt.target)
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            tgt(t)
    elif isinstance(stmt, ast.For):
        tgt(stmt.target)
    elif isinstance(stmt, ast.With):
        for item in stmt.items:
            if item.optional_vars is not None:
                tgt(item.optional_vars)
    return out


class DonationCheck(Check):
    rule = "donation"
    description = ("no use of a donated buffer reference after the "
                   "donating call; the prefix pool stays undonated")

    # attribute callables known to donate (position is 0-based over the
    # call's own positional args): SlotEngine.decode donates the cache
    # (Container builds it with donate_argnums=(1,)), self._insert binds
    # the module-level donating scatter.
    KNOWN_DONATING_ATTRS = {"decode": (1,), "_insert": (0,)}

    def run(self, project):
        for f in project.files:
            if f.tree is None:
                continue
            module_names = {}
            for node in f.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    jc = _jit_call(node.value)
                    if jc is not None:
                        pos = _donate_positions(jc)
                        if pos:
                            module_names[node.targets[0].id] = pos
            for fn in ast.walk(f.tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from self._check_function(f, fn, module_names)

    # -- use-after-donation ---------------------------------------------------
    def _check_function(self, f, fn, module_names):
        donating = dict(module_names)
        findings: list[Finding] = []
        seen: set[tuple[int, str]] = set()
        self._scan_block(f, fn.body, donating, {}, findings, seen)
        yield from findings
        yield from self._check_pool_donation(f, fn)

    def _scan_block(self, f, stmts, donating, pending, findings, seen):
        """Linear walk; ``pending`` maps a donated expression string to the
        line it was donated on. Branches fork a copy and merge by union;
        loop bodies run twice so a donation can collide with a read in the
        next iteration."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                pb = dict(pending)
                self._scan_block(f, stmt.body, donating, pb, findings, seen)
                po = dict(pending)
                self._scan_block(f, stmt.orelse, donating, po, findings,
                                 seen)
                pending.clear()
                pending.update(pb)
                pending.update(po)
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                self._simple_stmt(f, stmt, donating, pending, findings,
                                  seen, header_only=True)
                for _ in range(2):
                    self._scan_block(f, stmt.body, donating, pending,
                                     findings, seen)
                self._scan_block(f, stmt.orelse, donating, pending,
                                 findings, seen)
                continue
            if isinstance(stmt, ast.Try):
                self._scan_block(f, stmt.body, donating, pending, findings,
                                 seen)
                for h in stmt.handlers:
                    self._scan_block(f, h.body, donating, dict(pending),
                                     findings, seen)
                self._scan_block(f, stmt.finalbody, donating, pending,
                                 findings, seen)
                continue
            if isinstance(stmt, ast.With):
                self._simple_stmt(f, stmt, donating, pending, findings,
                                  seen, header_only=True)
                self._scan_block(f, stmt.body, donating, pending, findings,
                                 seen)
                continue
            self._simple_stmt(f, stmt, donating, pending, findings, seen)

    def _simple_stmt(self, f, stmt, donating, pending, findings, seen,
                     header_only=False):
        nodes = (list(ast.iter_child_nodes(stmt))[:1] if header_only
                 else [stmt])
        # 1) reads of still-pending donated references
        for root in nodes:
            for node in _walk_stmt(root) if root is stmt \
                    else ast.walk(root):
                if isinstance(node, (ast.Name, ast.Attribute)) and \
                        isinstance(getattr(node, "ctx", None), ast.Load):
                    expr = self.unparse(node)
                    if expr in pending:
                        key = (node.lineno, expr)
                        if key not in seen:
                            seen.add(key)
                            findings.append(Finding(
                                rule=self.rule, file=f.rel,
                                line=node.lineno,
                                message=f"{expr!r} is read after being "
                                        f"donated on line "
                                        f"{pending[expr]} -- the buffer "
                                        "may already be overwritten",
                                hint="re-bind the reference from the "
                                     "call's output (x = step(x, ...)) "
                                     "before any further use"))
        if header_only:
            return
        # 2) register new local donating names + new donations
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            jc = _jit_call(stmt.value)
            if jc is not None:
                pos = _donate_positions(jc)
                if pos:
                    donating[stmt.targets[0].id] = pos
                else:           # rebound to a non-donating jit
                    donating.pop(stmt.targets[0].id, None)
        for node in _walk_stmt(stmt):
            if not isinstance(node, ast.Call):
                continue
            positions = None
            if isinstance(node.func, ast.Name):
                positions = donating.get(node.func.id)
            elif isinstance(node.func, ast.Attribute):
                positions = (donating.get(node.func.attr)
                             or self.KNOWN_DONATING_ATTRS.get(
                                 node.func.attr))
            if not positions:
                continue
            for p in positions:
                if p < len(node.args) and \
                        isinstance(node.args[p], (ast.Name, ast.Attribute)):
                    pending[self.unparse(node.args[p])] = node.lineno
        # 3) re-binds clear pending donations
        for expr in _store_targets(stmt):
            pending.pop(expr, None)

    # -- prefix-pool donation -------------------------------------------------
    def _check_pool_donation(self, f, fn):
        """A jitted step whose donated argument is the live page pool:
        find ``v = jax.jit(..., donate_argnums=K)`` followed by
        ``v.lower(...)`` / ``v(...)`` with a pool-named expression at a
        donated position."""
        # every rebinding of each name, in line order: names like `jitted`
        # are reused across branches (some donating, some not), so a call
        # site resolves against its NEAREST preceding assignment
        bindings: dict[str, list[tuple[int, tuple[int, ...]]]] = {}
        any_donating = False
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                jc = _jit_call(stmt.value)
                pos = _donate_positions(jc) if jc is not None else ()
                bindings.setdefault(stmt.targets[0].id, []).append(
                    (stmt.lineno, pos))
                any_donating = any_donating or bool(pos)
        if not any_donating:
            return
        for hist in bindings.values():
            hist.sort()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = None
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "lower" and \
                    isinstance(node.func.value, ast.Name):
                name = node.func.value.id
            elif isinstance(node.func, ast.Name):
                name = node.func.id
            positions: tuple[int, ...] = ()
            for lineno, pos in bindings.get(name or "", ()):
                if lineno < node.lineno:
                    positions = pos
                else:
                    break
            for p in positions:
                if p < len(node.args) and \
                        _POOL_RE.search(self.unparse(node.args[p])):
                    yield Finding(
                        rule=self.rule, file=f.rel, line=node.lineno,
                        message=f"donated argument {p} of {name!r} is the "
                                "live prefix page pool "
                                f"({self.unparse(node.args[p])!r})",
                        hint="the prefix-prefill path reads cached pages "
                             "out of the pool; lower it WITHOUT "
                             "donate_argnums (see Container."
                             "lower_serve_step, pfx branch)")
