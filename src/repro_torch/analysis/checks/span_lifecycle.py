"""span-lifecycle: every trace emission is a legal state transition.

The span state machine lives in ``obs/tracing.py`` as data
(``SPAN_KINDS`` + ``SPAN_TRANSITIONS``); ``validate_span_log`` replays it
at runtime, ``export_chrome`` renders it, and the bitwise
live-vs-recompute test relies on the lifecycle derived from it. This
check keeps the three representations in sync without importing any of
them:

1. the transition table's keys must be exactly ``SPAN_KINDS`` (adding a
   span type without wiring its transitions is an error);
2. every kind must appear literally in ``export_chrome`` (the renderer
   handles it) -- a new span type silently dropped from traces is how
   lifecycle bugs hide;
3. every ``buffer.record(rid, "<kind>", tick)`` emission site must name a
   known kind, and -- for orchestrator code -- the *set* of kinds a file
   scope emits must be closed under the table: each emitted kind either
   may start a lifecycle or has an emitted predecessor, and each emitted
   non-terminal kind has an emitted successor (``preempt`` without
   ``resume``/``shed``/``reject`` anywhere is a stuck lifecycle);
4. ``TERMINAL_SPANS`` must be a literal subset of ``SPAN_KINDS`` and
   genuinely terminal: no transition may name a terminal kind as a
   predecessor (``validate_span_log`` refuses successors of terminals at
   runtime, and the cross-process fleet-closure check counts a lifecycle
   closed at them -- a table that disagrees makes the fabric's
   zero-lost-requests gate vacuous).

In the port, ``TRACING_REL`` is the port's own ``obs/tracing.py``: its
``SPAN_KINDS``, ``SPAN_TRANSITIONS``, ``TERMINAL_SPANS`` and
``export_chrome``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import Check, Finding

TRACING_REL = "src/repro_torch/orchestrator/obs/tracing.py"


def _module_assign(tree: ast.Module, name: str) -> ast.expr | None:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node.value
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and \
                node.target.id == name and node.value is not None:
            return node.value
    return None


def _find_function(tree: ast.Module, name: str):
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


class SpanLifecycleCheck(Check):
    rule = "span-lifecycle"
    description = ("trace emissions name known span kinds and form legal, "
                   "closed lifecycles; exporter handles every kind")

    def run(self, project):
        tracing = project.locate(TRACING_REL)
        if tracing is None or tracing.tree is None:
            yield Finding(
                rule=self.rule, file=TRACING_REL, line=1,
                message="cannot locate obs/tracing.py to derive the span "
                        "state machine",
                severity="warning",
                hint="run repro lint from the repo root")
            return
        kinds, transitions, table_findings = self._load_machine(tracing)
        yield from table_findings
        if kinds and transitions:
            yield from self._check_exporter(tracing, kinds)
        # emission sites; orchestrator files pool into one closure check
        # (the router records "route"/"reroute" in its own buffer, the
        # scheduler continues with "submit".."complete" in the pod's --
        # lifecycles cross files AND processes by design; the runtime
        # analog pools per-process span files via validate_fleet_closure)
        emitted: dict[str, tuple[str, int]] = {}  # kind -> first site
        for f in project.files:
            if f.tree is None or f is tracing:
                continue
            orchestrator = self._orchestrator_scope(f.rel)
            for node in ast.walk(f.tree):
                site = self._emission(node)
                if site is None:
                    continue
                kind_node, line = site
                kind = self.const_str(kind_node)
                if kind is None:
                    yield Finding(
                        rule=self.rule, file=f.rel, line=line,
                        message="span kind should be a string literal so "
                                "the lifecycle is statically checkable",
                        severity="warning",
                        hint="emit a literal kind; branch at the call "
                             "site, not inside the kind argument")
                    continue
                if kinds and kind not in kinds:
                    yield Finding(
                        rule=self.rule, file=f.rel, line=line,
                        message=f"unknown span kind {kind!r} (not in "
                                "tracing.SPAN_KINDS)",
                        hint="add the kind to SPAN_KINDS + "
                             "SPAN_TRANSITIONS and teach export_chrome "
                             "to render it")
                    continue
                if orchestrator:
                    emitted.setdefault(kind, (f.rel, line))
        if transitions and emitted:
            yield from self._check_closure(emitted, transitions)

    # -- deriving the machine -------------------------------------------------
    def _load_machine(self, tracing):
        findings = []
        kinds: tuple[str, ...] = ()
        transitions: dict[str, tuple] = {}
        kinds_node = _module_assign(tracing.tree, "SPAN_KINDS")
        trans_node = _module_assign(tracing.tree, "SPAN_TRANSITIONS")
        try:
            if kinds_node is not None:
                kinds = tuple(ast.literal_eval(kinds_node))
        except ValueError:
            kinds_node = None
        try:
            if trans_node is not None:
                transitions = dict(ast.literal_eval(trans_node))
        except ValueError:
            trans_node = None
        if kinds_node is None:
            findings.append(Finding(
                rule=self.rule, file=tracing.rel, line=1,
                message="SPAN_KINDS is missing or not a literal tuple"))
        if trans_node is None:
            findings.append(Finding(
                rule=self.rule, file=tracing.rel, line=1,
                message="SPAN_TRANSITIONS is missing or not a literal "
                        "dict",
                hint="define SPAN_TRANSITIONS = {kind: (allowed "
                     "predecessors...)} next to SPAN_KINDS"))
        if kinds and transitions and set(kinds) != set(transitions):
            missing = sorted(set(kinds) - set(transitions))
            extra = sorted(set(transitions) - set(kinds))
            findings.append(Finding(
                rule=self.rule, file=tracing.rel, line=1,
                message="SPAN_TRANSITIONS keys != SPAN_KINDS "
                        f"(missing {missing}, extra {extra})",
                hint="every span kind needs an entry in the transition "
                     "table"))
        findings.extend(self._check_terminals(tracing, kinds, transitions))
        return kinds, transitions, findings

    def _check_terminals(self, tracing, kinds, transitions):
        term_node = _module_assign(tracing.tree, "TERMINAL_SPANS")
        try:
            terminals = (tuple(ast.literal_eval(term_node))
                         if term_node is not None else None)
        except ValueError:
            terminals = None
        if terminals is None:
            yield Finding(
                rule=self.rule, file=tracing.rel, line=1,
                message="TERMINAL_SPANS is missing or not a literal "
                        "tuple",
                hint="define TERMINAL_SPANS next to SPAN_TRANSITIONS; "
                     "the fleet-closure check counts lifecycles closed "
                     "at these kinds")
            return
        if kinds:
            unknown = sorted(set(terminals) - set(kinds))
            if unknown:
                yield Finding(
                    rule=self.rule, file=tracing.rel, line=1,
                    message=f"TERMINAL_SPANS entries {unknown} are not "
                            "in SPAN_KINDS")
        for kind in terminals:
            followers = sorted(
                k for k, preds in transitions.items()
                if isinstance(preds, tuple) and kind in preds)
            if followers:
                yield Finding(
                    rule=self.rule, file=tracing.rel, line=1,
                    message=f"terminal span {kind!r} is a legal "
                            f"predecessor of {followers} -- terminals "
                            "must have no successors",
                    hint="either drop the kind from TERMINAL_SPANS or "
                         "remove it from those transition entries; "
                         "validate_span_log and the fleet-closure check "
                         "both assume terminals end the log")

    def _check_exporter(self, tracing, kinds):
        exporter = _find_function(tracing.tree, "export_chrome")
        if exporter is None:
            yield Finding(
                rule=self.rule, file=tracing.rel, line=1,
                message="export_chrome not found; span kinds have no "
                        "renderer")
            return
        literals = {n.value for n in ast.walk(exporter)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
        for kind in kinds:
            if kind not in literals:
                yield Finding(
                    rule=self.rule, file=tracing.rel,
                    line=exporter.lineno,
                    message=f"span kind {kind!r} is not handled by "
                            "export_chrome",
                    hint="add a phase/instant mapping for the new kind "
                         "so Chrome traces keep rendering it")

    # -- emission sites -------------------------------------------------------
    @staticmethod
    def _emission(node: ast.AST):
        """``<buffer>.record(rid, kind, tick, ...)`` -- a trace emission
        is a .record call with >= 3 positional args (metric .record calls
        take one)."""
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "record" and len(node.args) >= 3:
            return node.args[1], node.lineno
        return None

    @staticmethod
    def _orchestrator_scope(rel: str) -> bool:
        """Files whose emissions participate in the closure check: the
        orchestrator package (minus obs/, whose buffers are generic), or
        any file named like an orchestrator module (lint fixtures)."""
        parts = rel.replace("\\", "/").split("/")
        if "obs" in parts:
            return False
        return "orchestrator" in parts[:-1] or \
            parts[-1] in ("scheduler.py", "router.py", "pod.py")

    def _check_closure(self, emitted, transitions):
        """Fleet-wide closure over orchestrator emissions: every emitted
        kind must be reachable (may start a lifecycle, or some emitted
        kind is a legal predecessor) and every emitted non-terminal kind
        must have an emitted successor. One hop each way transitively
        covers whole chains (``complete`` needs ``prefill``/
        ``decode_chunk``, which in turn need ``admit``...)."""
        kinds = set(emitted)
        for kind in sorted(emitted):
            rel, line = emitted[kind]
            preds = transitions.get(kind, ())
            if preds and None not in preds and not (set(preds) & kinds):
                yield Finding(
                    rule=self.rule, file=rel, line=line,
                    message=f"span {kind!r} is emitted but none of its "
                            f"legal predecessors {tuple(preds)} are "
                            "emitted anywhere -- the transition can "
                            "never be legal",
                    hint="emit the predecessor span (or delete this "
                         "unreachable emission)")
            successors = tuple(k for k, pr in transitions.items()
                               if kind in pr)
            if successors and not (set(successors) & kinds):
                yield Finding(
                    rule=self.rule, file=rel, line=line,
                    message=f"span {kind!r} is emitted but no successor "
                            f"({successors}) is ever emitted -- "
                            "lifecycles entering this state get stuck",
                    hint="a non-terminal span needs a continuation "
                         "(e.g. every preempt must later resume, shed "
                         "or reject)")
