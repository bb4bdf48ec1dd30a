"""metrics-writer: single-writer completion metrics.

The fleet rollup and the bitwise live-vs-recompute acceptance test both
assume the completion histograms (``latency_ticks``, ``ttft_ticks``,
``itl_milliticks``) and counters (``requests_completed``, ``tokens_out``)
have exactly one writer: ``obs/report.py:observe_completion``. A second
recording site anywhere else desynchronises the recompute and silently
breaks ``completion_snapshot`` equality. Registering the instruments
elsewhere (for eager visibility in ``repro top``) is fine -- only
``.record(...)`` / ``.inc(...)`` is restricted.

The check also guards registry hygiene: one name -> one instrument kind
across the tree, and label values must be bounded (no f-strings, no
``.format``/``%`` interpolation, no per-request ``rid`` labels -- each
distinct label set is a separate registry series).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.core import Check, Finding

PROTECTED_HISTOGRAMS = ("latency_ticks", "ttft_ticks", "itl_milliticks")
PROTECTED_COUNTERS = ("requests_completed", "tokens_out")
WRITER_SUFFIX = "obs/report.py"

_FACTORIES = ("counter", "gauge", "histogram")
_RESERVED_KWARGS = {"width", "n_buckets"}
_WRITE_METHODS = {"record", "inc"}


def _is_writer(rel: str) -> bool:
    return rel.replace("\\", "/").endswith(WRITER_SUFFIX)


def _protected_factory(call: ast.Call) -> str | None:
    """The protected metric name when ``call`` is a factory call creating
    one of the completion instruments, else None."""
    if not isinstance(call.func, ast.Attribute) or not call.args:
        return None
    name = Check.const_str(call.args[0])
    if call.func.attr == "histogram" and name in PROTECTED_HISTOGRAMS:
        return name
    if call.func.attr == "counter" and name in PROTECTED_COUNTERS:
        return name
    return None


class MetricsWriterCheck(Check):
    rule = "metrics-writer"
    description = ("observe_completion is the only writer of completion "
                   "metrics; registry names collision-free, label values "
                   "bounded")

    def run(self, project):
        # name -> (kind, rel, line) across the whole scanned tree
        registrations: dict[str, tuple[str, str, int]] = {}
        for f in project.files:
            if f.tree is None:
                continue
            writer = _is_writer(f.rel)
            # var expr -> protected metric name, from assignments like
            # ``h = reg.histogram("ttft_ticks", ...)``
            bound: dict[str, str] = {}
            for node in ast.walk(f.tree):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    name = _protected_factory(node.value)
                    if name:
                        for t in node.targets:
                            if isinstance(t, (ast.Name, ast.Attribute)):
                                bound[self.unparse(t)] = name
                if not isinstance(node, ast.Call):
                    continue
                yield from self._registration(f, node, registrations)
                yield from self._labels(f, node)
                if not writer:
                    yield from self._write_site(f, node, bound)

    # -- the single-writer rule -----------------------------------------------
    def _write_site(self, f, node: ast.Call, bound):
        func = node.func
        if not isinstance(func, ast.Attribute) or \
                func.attr not in _WRITE_METHODS:
            return
        recv = func.value
        name = None
        if isinstance(recv, ast.Call):            # chained factory().record
            name = _protected_factory(recv)
        elif isinstance(recv, (ast.Name, ast.Attribute)):
            name = bound.get(self.unparse(recv))
        if name:
            yield Finding(
                rule=self.rule, file=f.rel, line=node.lineno,
                message=f"completion metric {name!r} is recorded outside "
                        f"{WRITER_SUFFIX}:observe_completion",
                hint="route the observation through observe_completion() "
                     "so the live registry stays bitwise-recomputable "
                     "from the trace buffers")

    # -- registry hygiene -----------------------------------------------------
    def _registration(self, f, node: ast.Call, registrations):
        func = node.func
        if not isinstance(func, ast.Attribute) or \
                func.attr not in _FACTORIES or not node.args:
            return
        name = self.const_str(node.args[0])
        if name is None:
            return
        prior = registrations.get(name)
        if prior is None:
            registrations[name] = (func.attr, f.rel, node.lineno)
        elif prior[0] != func.attr:
            yield Finding(
                rule=self.rule, file=f.rel, line=node.lineno,
                message=f"metric name {name!r} registered as "
                        f"{func.attr} here but as {prior[0]} at "
                        f"{prior[1]}:{prior[2]}",
                hint="one name -> one instrument kind; rename one of "
                     "the two")

    def _labels(self, f, node: ast.Call):
        func = node.func
        if not isinstance(func, ast.Attribute) or \
                func.attr not in _FACTORIES or not node.args:
            return
        if self.const_str(node.args[0]) is None:
            return
        for kw in node.keywords:
            if kw.arg is None or kw.arg in _RESERVED_KWARGS:
                continue
            bad = self._unbounded(kw.value)
            if bad:
                yield Finding(
                    rule=self.rule, file=f.rel, line=node.lineno,
                    message=f"label {kw.arg!r} has unbounded value "
                            f"({bad}): each distinct value is a separate "
                            "registry series",
                    hint="label values must come from a small fixed set "
                         "(pod id, phase, reason); put per-request detail "
                         "in the trace, not the label")

    @staticmethod
    def _unbounded(value: ast.expr) -> str | None:
        if isinstance(value, ast.JoinedStr):
            return "f-string"
        if isinstance(value, ast.Call) and \
                isinstance(value.func, ast.Attribute) and \
                value.func.attr == "format":
            return ".format() interpolation"
        if isinstance(value, ast.BinOp) and isinstance(value.op, ast.Mod):
            return "%-interpolation"
        for sub in ast.walk(value):
            if isinstance(sub, ast.Name) and sub.id == "rid":
                return "per-request rid"
            if isinstance(sub, ast.Attribute) and sub.attr == "rid":
                return "per-request rid"
        return None
