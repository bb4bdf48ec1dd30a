"""repro lint: the checker framework behind ``repro lint``.

The serving stack runs on hand-maintained contracts -- the single-writer
completion-metrics rule, PagePool's refcount discipline, the Container's
donation conventions, the span-lifecycle state machine the bitwise
live-vs-recompute check depends on. Each was enforced only by convention
and by whichever test happened to trip. This module turns them into
machine-checked invariants: a :class:`Check` walks parsed ASTs and yields
:class:`Finding`s with a rule id, ``file:line`` and a fix hint.

Conventions:

* **Suppression** -- ``# repro: lint-ok[rule-id]`` on the flagged line (or
  the line directly above it) silences that rule there; a comma list
  silences several, a bare ``# repro: lint-ok`` silences everything on the
  line. Suppressions are for *justified* exceptions (say why in a nearby
  comment), not for making CI green.
* **Baseline** -- ``--baseline findings.json`` filters out previously
  recorded findings (``--write-baseline`` records the current set), so the
  suite can land on a tree with known debt and only fail on NEW findings.
* **Ratchet** -- ``--ratchet ratchet.json`` fails the run when the number
  of ``lint-ok`` suppressions GREW past the committed count
  (``--write-ratchet`` records it). Baselines grandfather old findings;
  the ratchet stops new debt from hiding behind suppression comments --
  CI gates on both, so the only way to add a suppression is to commit the
  updated ratchet file in the same change, where review sees it.
* **Scope** -- checks see a :class:`Project` (every scanned file, parsed
  once) so cross-file rules (is ``PagePool.pause`` exercised by the
  property tests?) read both sides. Files outside the lint scope that a
  rule depends on (``page_pool.py`` internals, ``tracing.py``'s span
  table) are pulled in read-only via :meth:`Project.locate`.

Checks are pure AST + string analysis: no imports of the checked code, no
jax, so ``repro lint`` runs in well under a second and CI can gate on it
cheaply.
"""

from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

# directories never walked when a scan path is a directory (explicit file
# arguments bypass this -- the fixture tests lint seeded-violation files)
EXCLUDED_DIRS = {"__pycache__", ".git", ".stevedore", ".hypothesis",
                 "lint_fixtures", ".pytest_cache"}

_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*lint-ok(?:\[([A-Za-z0-9_,\- ]*)\])?")

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One rule violation at ``file:line``."""
    rule: str
    file: str                   # path as scanned (repo-relative in CI)
    line: int
    message: str
    severity: str = "error"
    hint: str = ""

    @property
    def key(self) -> str:
        """Stable identity for baselines: rule + location."""
        return f"{self.rule}:{self.file}:{self.line}"

    def render(self) -> str:
        out = f"{self.file}:{self.line}: {self.severity} [{self.rule}] " \
              f"{self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class FileCtx:
    """One scanned file: source, parsed AST, and its suppression map."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        try:
            self.tree: ast.Module | None = ast.parse(self.source,
                                                     filename=rel)
        except SyntaxError as e:
            self.tree = None
            self.syntax_error = e
        # line -> set of suppressed rule ids ("*" = all)
        self.suppressions: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = ({r.strip() for r in m.group(1).split(",") if r.strip()}
                     if m.group(1) else {"*"})
            self.suppressions[i] = rules

    def suppressed(self, rule: str, line: int) -> bool:
        """A finding is suppressed by a marker on its own line or on the
        line directly above (for lines too long to carry a comment)."""
        for ln in (line, line - 1):
            rules = self.suppressions.get(ln)
            if rules and ("*" in rules or rule in rules):
                return True
        return False


class Project:
    """Everything a check may look at: scanned files + root-anchored
    lookups for contract files outside the scan scope."""

    def __init__(self, root: Path, files: list[FileCtx]):
        self.root = root
        self.files = files
        self._extra: dict[str, FileCtx | None] = {}

    def locate(self, rel: str) -> FileCtx | None:
        """Find a file by repo-relative suffix: scanned files first, then
        a read-only load from ``root/rel``. Returns None when absent."""
        suffix = rel.replace("\\", "/")
        for f in self.files:
            if f.rel.replace("\\", "/").endswith(suffix):
                return f
        if rel not in self._extra:
            p = self.root / rel
            self._extra[rel] = FileCtx(p, rel) if p.is_file() else None
        return self._extra[rel]


class Check:
    """Base class: subclasses set ``rule``/``description`` and implement
    ``run(project)`` yielding Findings. One instance per lint run."""

    rule = "abstract"
    description = ""

    def run(self, project: Project):
        raise NotImplementedError

    # -- shared AST helpers ---------------------------------------------------
    @staticmethod
    def unparse(node: ast.AST) -> str:
        try:
            return ast.unparse(node)
        except Exception:               # pragma: no cover - malformed node
            return "<expr>"

    @staticmethod
    def call_kwarg(call: ast.Call, name: str) -> ast.expr | None:
        for kw in call.keywords:
            if kw.arg == name:
                return kw.value
        return None

    @staticmethod
    def const_str(node: ast.AST) -> str | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)
    suppressed: int = 0
    baselined: int = 0
    files: int = 0

    @property
    def errors(self) -> int:
        return sum(1 for f in self.findings if f.severity == "error")

    @property
    def warnings(self) -> int:
        return sum(1 for f in self.findings if f.severity == "warning")


def _collect_files(paths: list[str]) -> list[Path]:
    out: list[Path] = []
    seen: set[Path] = set()
    for p in paths:
        path = Path(p)
        if path.is_file():
            candidates = [path]
        elif path.is_dir():
            candidates = sorted(
                f for f in path.rglob("*.py")
                if not (set(f.parts) & EXCLUDED_DIRS))
        else:
            raise FileNotFoundError(f"lint path does not exist: {p}")
        for f in candidates:
            r = f.resolve()
            if r not in seen:
                seen.add(r)
                out.append(f)
    return out


def find_root(paths: list[str]) -> Path:
    """Repo root for cross-file lookups: the nearest ancestor of a scan
    path that contains ``src/repro_torch``; the cwd otherwise."""
    for p in paths:
        d = Path(p).resolve()
        if d.is_file():
            d = d.parent
        for anc in (d, *d.parents):
            if (anc / "src" / "repro_torch").is_dir():
                return anc
    return Path.cwd()


def all_checks() -> list[Check]:
    from repro_torch.analysis.checks import ALL_CHECKS
    return [cls() for cls in ALL_CHECKS]


def run_lint(paths: list[str], *, rules: list[str] | None = None,
             baseline: set[str] | None = None) -> LintResult:
    """Run every (selected) check over ``paths``; returns unsuppressed,
    un-baselined findings sorted by location."""
    checks = all_checks()
    if rules:
        known = {c.rule for c in checks}
        unknown = [r for r in rules if r not in known]
        if unknown:
            raise ValueError(
                f"unknown rule(s) {unknown}; known: {sorted(known)}")
        checks = [c for c in checks if c.rule in rules]
    files = [FileCtx(p, str(p)) for p in _collect_files(paths)]
    project = Project(find_root(paths), files)
    by_rel = {f.rel: f for f in files}
    result = LintResult(files=len(files))

    findings: list[Finding] = []
    for f in files:
        if f.tree is None:
            findings.append(Finding(
                rule="syntax", file=f.rel, line=f.syntax_error.lineno or 1,
                message=f"syntax error: {f.syntax_error.msg}"))
    for check in checks:
        findings.extend(check.run(project))

    for finding in sorted(findings,
                          key=lambda f: (f.file, f.line, f.rule)):
        ctx = by_rel.get(finding.file)
        if ctx is not None and ctx.suppressed(finding.rule, finding.line):
            result.suppressed += 1
            continue
        if baseline and finding.key in baseline:
            result.baselined += 1
            continue
        result.findings.append(finding)
    return result


def load_baseline(path: str) -> set[str]:
    data = json.loads(Path(path).read_text())
    return set(data.get("findings", []))


def load_ratchet(path: str) -> int:
    data = json.loads(Path(path).read_text())
    return int(data.get("suppressions", 0))


def write_ratchet(path: str, result: LintResult) -> None:
    Path(path).write_text(json.dumps(
        {"version": 1, "suppressions": result.suppressed}, indent=1) + "\n")


def write_baseline(path: str, result: LintResult) -> None:
    Path(path).write_text(json.dumps(
        {"version": 1,
         "findings": sorted(f.key for f in result.findings)}, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro lint",
        description="project-invariant static analysis for the serving "
                    "stack (AST-based, no imports of the checked code)")
    ap.add_argument("paths", nargs="*", default=["src", "tests"],
                    help="files or directories to scan (default: src tests)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings too, not just errors")
    ap.add_argument("--rule", action="append", default=None, metavar="ID",
                    help="run only this rule (repeatable)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="ignore findings recorded in this baseline file")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="record the current findings as the baseline")
    ap.add_argument("--ratchet", default=None, metavar="FILE",
                    help="fail when lint-ok suppressions exceed the count "
                         "committed in FILE (the suppression ratchet)")
    ap.add_argument("--write-ratchet", default=None, metavar="FILE",
                    help="record the current suppression count as the "
                         "ratchet baseline")
    ap.add_argument("--list-rules", action="store_true",
                    help="list rule ids and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for c in all_checks():
            print(f"{c.rule:18s} {c.description}")
        return 0

    paths = args.paths or ["src", "tests"]
    baseline = load_baseline(args.baseline) if args.baseline else None
    try:
        result = run_lint(paths, rules=args.rule, baseline=baseline)
    except (FileNotFoundError, ValueError) as e:
        print(f"repro lint: {e}", file=sys.stderr)
        return 2
    if args.write_baseline:
        write_baseline(args.write_baseline, result)
        print(f"wrote {len(result.findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0
    if args.write_ratchet:
        write_ratchet(args.write_ratchet, result)
        print(f"wrote suppression count {result.suppressed} to "
              f"{args.write_ratchet}")
        return 0
    for f in result.findings:
        print(f.render())
    extras = []
    if result.suppressed:
        extras.append(f"{result.suppressed} suppressed")
    if result.baselined:
        extras.append(f"{result.baselined} baselined")
    tail = f" ({', '.join(extras)})" if extras else ""
    print(f"repro lint: {result.errors} error(s), "
          f"{result.warnings} warning(s) across {result.files} "
          f"file(s){tail}")
    failing = result.errors + (result.warnings if args.strict else 0)
    if args.ratchet:
        try:
            allowed = load_ratchet(args.ratchet)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            print(f"repro lint: cannot read ratchet {args.ratchet}: {e}",
                  file=sys.stderr)
            return 2
        if result.suppressed > allowed:
            print(f"repro lint: suppression ratchet FAILED -- "
                  f"{result.suppressed} lint-ok marker(s), baseline "
                  f"allows {allowed}; fix the finding or commit an "
                  f"updated ratchet (--write-ratchet {args.ratchet})")
            failing += 1
        elif result.suppressed < allowed:
            print(f"repro lint: suppressions dropped to "
                  f"{result.suppressed} (baseline {allowed}) -- tighten "
                  f"the ratchet with --write-ratchet {args.ratchet}")
    return 1 if failing else 0
