"""pool-mutation: PagePool internals have one owner.

PagePool's refcount/free-list/registry bookkeeping (``free``, ``table``,
``owned``, ``shared``, ``reserved``, ``refcount``, ``radix``, ``store``,
``events``, ``_pinned``, ``paused``, ``_clock``) is kept consistent by
its own methods plus the ``check()`` invariant sweep. A scheduler that
pokes ``pool.refcount`` -- or reaches into the radix tree or the spill
store -- directly bypasses both, and the corruption only surfaces ticks
later as a double-free or a leaked page. Two sub-rules:

* outside ``page_pool.py``, no store/del/augmented-assign to a pool
  internal and no mutating container method (``append``, ``pop``,
  ``add``, ...) called on one;
* every *public* mutating method of PagePool (derived from the class
  body by fixpoint over self-calls) must be exercised by the property
  tests in ``tests/test_page_pool.py``, under ``check()`` -- an
  invariant nobody drives through the random schedule is an invariant
  that silently rots.

In the port, ``POOL_REL`` is the port's own ``page_pool.py``, so its
internals and its public mutating methods are derived from the pool that
the port runs. ``TESTS_REL`` stays ``tests/test_page_pool.py``: the port's
pool is driven by those very test bodies (``tests/torch_ref.py`` runs each
of them on the port through ``tests/test_torch_page_pool.py``, which itself
names no ``PagePool`` method and so would read as covering nothing).
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.core import Check, Finding

POOL_REL = "src/repro_torch/orchestrator/page_pool.py"
TESTS_REL = "tests/test_page_pool.py"

# bookkeeping attributes; intersected with what PagePool.__init__ actually
# assigns so renames don't leave the check pinned to stale names
INTERNAL_CANDIDATES = {"free", "table", "owned", "shared", "reserved",
                       "refcount", "radix", "store", "events", "_pinned",
                       "paused", "_clock"}
MUTATORS = {"append", "extend", "insert", "remove", "pop", "popleft",
            "clear", "add", "discard", "update", "setdefault", "sort"}

_POOL_RE = re.compile(r"pool", re.IGNORECASE)


def _is_pool_file(rel: str) -> bool:
    return rel.replace("\\", "/").endswith("page_pool.py")


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class PoolMutationCheck(Check):
    rule = "pool-mutation"
    description = ("no mutation of PagePool internals outside "
                   "page_pool.py; every public mutating method covered "
                   "by the property tests")

    def run(self, project):
        pool = project.locate(POOL_REL)
        internals = self._derive_internals(pool)
        for f in project.files:
            if f.tree is None or _is_pool_file(f.rel):
                continue
            yield from self._check_file(f, internals)
        # coverage half only when page_pool.py itself is in scope
        if pool is not None and pool.tree is not None and \
                any(_is_pool_file(f.rel) for f in project.files):
            yield from self._check_coverage(project, pool, internals)

    def _derive_internals(self, pool) -> set[str]:
        if pool is None or pool.tree is None:
            return set(INTERNAL_CANDIDATES)
        assigned = set()
        for cls in ast.walk(pool.tree):
            if not (isinstance(cls, ast.ClassDef) and
                    cls.name == "PagePool"):
                continue
            for fn in cls.body:
                if isinstance(fn, ast.FunctionDef) and \
                        fn.name == "__init__":
                    for node in ast.walk(fn):
                        targets = []
                        if isinstance(node, ast.Assign):
                            targets = node.targets
                        elif isinstance(node, (ast.AnnAssign,
                                               ast.AugAssign)):
                            targets = [node.target]
                        for t in targets:
                            attr = _self_attr(t)
                            if attr:
                                assigned.add(attr)
        return (assigned & INTERNAL_CANDIDATES) or set(INTERNAL_CANDIDATES)

    # -- external mutation ----------------------------------------------------
    def _pool_internal(self, node: ast.AST, internals) -> str | None:
        """``<pool-ish>.<internal>`` or a subscript of one; returns the
        attribute name."""
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) and node.attr in internals and \
                _POOL_RE.search(self.unparse(node.value)):
            return node.attr
        return None

    def _check_file(self, f, internals):
        for node in ast.walk(f.tree):
            targets = []
            verb = "assigned"
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets, verb = node.targets, "deleted"
            for t in targets:
                attr = self._pool_internal(t, internals)
                if attr:
                    yield Finding(
                        rule=self.rule, file=f.rel, line=node.lineno,
                        message=f"PagePool internal {attr!r} is {verb} "
                                "directly outside page_pool.py",
                        hint="go through a PagePool method (reserve/"
                             "alloc_upto/release/share/cow/...) so "
                             "refcounts and the free list stay "
                             "consistent under check()")
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in MUTATORS:
                attr = self._pool_internal(node.func.value, internals)
                if attr:
                    yield Finding(
                        rule=self.rule, file=f.rel, line=node.lineno,
                        message=f"mutating call .{node.func.attr}() on "
                                f"PagePool internal {attr!r} outside "
                                "page_pool.py",
                        hint="add/extend a PagePool method instead of "
                             "reaching into its bookkeeping")

    # -- property-test coverage -----------------------------------------------
    def _check_coverage(self, project, pool, internals):
        methods = self._public_mutating_methods(pool, internals)
        tests = project.locate(TESTS_REL)
        if tests is None or tests.tree is None:
            yield Finding(
                rule=self.rule, file=pool.rel, line=1,
                message=f"{TESTS_REL} not found; PagePool's mutating "
                        "API has no property coverage",
                severity="warning")
            return
        called = {n.func.attr for n in ast.walk(tests.tree)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)}
        for name, line in sorted(methods.items()):
            if name not in called:
                yield Finding(
                    rule=self.rule, file=pool.rel, line=line,
                    message=f"public mutating method {name!r} is never "
                            f"exercised by {TESTS_REL}",
                    hint="add it as an op in the random property "
                         "schedule so check() sees its effects "
                         "interleaved with the others")
        if "check" not in called:
            yield Finding(
                rule=self.rule, file=pool.rel, line=1,
                message=f"{TESTS_REL} never calls PagePool.check(); "
                        "mutations are not validated against the "
                        "invariants")

    def _public_mutating_methods(self, pool, internals) -> dict[str, int]:
        """Fixpoint: a method mutates if it writes a pool internal (or
        calls a container mutator on one) directly, or calls a mutating
        method; public = no leading underscore."""
        direct: dict[str, bool] = {}
        calls: dict[str, set[str]] = {}
        lines: dict[str, int] = {}
        for cls in ast.walk(pool.tree):
            if not (isinstance(cls, ast.ClassDef) and
                    cls.name == "PagePool"):
                continue
            for fn in cls.body:
                if not isinstance(fn, ast.FunctionDef) or \
                        fn.name == "__init__":
                    continue
                lines[fn.name] = fn.lineno
                calls[fn.name] = set()
                mutates = False
                for node in ast.walk(fn):
                    targets = []
                    if isinstance(node, ast.Assign):
                        targets = node.targets
                    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                        targets = [node.target]
                    elif isinstance(node, ast.Delete):
                        targets = node.targets
                    for t in targets:
                        base = t.value if isinstance(t, ast.Subscript) \
                            else t
                        if _self_attr(base) in internals:
                            mutates = True
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Attribute):
                        base = node.func.value
                        if isinstance(base, ast.Subscript):
                            base = base.value
                        if node.func.attr in MUTATORS and \
                                _self_attr(base) in internals:
                            mutates = True
                        if _self_attr(node.func) is not None or \
                                (isinstance(node.func.value, ast.Name)
                                 and node.func.value.id == "self"):
                            calls[fn.name].add(node.func.attr)
                direct[fn.name] = mutates
        mutating = {m for m, d in direct.items() if d}
        changed = True
        while changed:
            changed = False
            for m, callees in calls.items():
                if m not in mutating and callees & mutating:
                    mutating.add(m)
                    changed = True
        return {m: lines[m] for m in mutating if not m.startswith("_")}
