"""tests/test_lint.py on the port: ``repro_torch.analysis`` (the port's
``lint``) against ``repro.analysis``, on the CPU.

* Every test of tests/test_lint.py runs its own body on the port through
  ``torch_ref.check_both`` (one port test a reference test, named in its
  docstring): the body's ``run_lint``/``all_checks``/baseline helpers,
  ``lint_main`` and ``cli_main`` are the port's (``repro_torch.analysis``,
  ``repro_torch.cli``), and a body that still reaches the JAX package
  fails.
* On every fixture of ``tests/lint_fixtures`` (and on all of them in one
  run), the port's findings equal the reference's: rule, file, line,
  severity, message and hint, with the same suppressed and file counts.
* The tree lints clean under ``--strict`` with the committed ratchet, as
  the reference does, with the same counts.
* The port's ``span-lifecycle`` and ``pool-mutation`` read the port's own
  ``obs/tracing.py`` and ``page_pool.py``: a copy of each with a seeded
  violation, under a ``src/repro_torch`` tree in ``tmp_path``, is flagged
  by the port's linter and not by the JAX one. The seeded sources are
  strings written to ``tmp_path``, never code in this file.
* ``python -m repro_torch.cli lint`` runs in a process where ``import
  jax`` and ``import repro`` raise, and creates no runtime root.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as janalysis
import repro_torch.analysis as tanalysis
import test_lint as ref
import torch_ref

pytestmark = pytest.mark.orchestrator

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "lint_fixtures"
FIXTURE_FILES = sorted(str(p.relative_to(FIXTURES))
                       for p in FIXTURES.rglob("*.py"))


def _tmp(tmp_path):
    """A fresh directory for each package's run of a body."""
    def args(pkg, port):
        d = tmp_path / ("torch" if port else "jax")
        d.mkdir()
        return (d,)
    return args


def test_every_rule_has_a_fixture_case():
    """Mirrors test_lint.py::test_every_rule_has_a_fixture_case."""
    torch_ref.check_both(ref, "test_every_rule_has_a_fixture_case")


@pytest.mark.parametrize("rule", sorted(ref.CASES))
def test_rule_flags_bad_and_passes_good(rule):
    """Mirrors test_lint.py::test_rule_flags_bad_and_passes_good."""
    torch_ref.check_both(ref, "test_rule_flags_bad_and_passes_good",
                         args=lambda pkg, port: (rule,))


def test_findings_carry_location_and_hint():
    """Mirrors test_lint.py::test_findings_carry_location_and_hint."""
    torch_ref.check_both(ref, "test_findings_carry_location_and_hint")


def test_suppression_same_line_line_above_and_comma_list(tmp_path):
    """Mirrors test_lint.py::
    test_suppression_same_line_line_above_and_comma_list."""
    torch_ref.check_both(
        ref, "test_suppression_same_line_line_above_and_comma_list",
        args=_tmp(tmp_path))


def test_baseline_roundtrip_filters_known_findings(tmp_path):
    """Mirrors test_lint.py::test_baseline_roundtrip_filters_known_findings."""
    torch_ref.check_both(ref, "test_baseline_roundtrip_filters_known_findings",
                         args=_tmp(tmp_path))


def test_syntax_error_is_reported_not_crashed(tmp_path):
    """Mirrors test_lint.py::test_syntax_error_is_reported_not_crashed."""
    torch_ref.check_both(ref, "test_syntax_error_is_reported_not_crashed",
                         args=_tmp(tmp_path))


def test_unknown_rule_rejected():
    """Mirrors test_lint.py::test_unknown_rule_rejected."""
    torch_ref.check_both(ref, "test_unknown_rule_rejected")


def test_cli_exit_codes(capsys):
    """Mirrors test_lint.py::test_cli_exit_codes (through
    ``repro_torch.cli.main`` on the port)."""
    torch_ref.check_both(ref, "test_cli_exit_codes",
                         args=lambda pkg, port: (capsys,))


def test_cli_strict_fails_on_warnings(tmp_path):
    """Mirrors test_lint.py::test_cli_strict_fails_on_warnings."""
    torch_ref.check_both(ref, "test_cli_strict_fails_on_warnings",
                         args=_tmp(tmp_path))


def test_lint_does_not_create_runtime_state(tmp_path):
    """Mirrors test_lint.py::test_lint_does_not_create_runtime_state."""
    torch_ref.check_both(ref, "test_lint_does_not_create_runtime_state",
                         args=_tmp(tmp_path), needs_monkeypatch=True)


def test_current_tree_lints_clean_strict():
    """Mirrors test_lint.py::test_current_tree_lints_clean_strict."""
    torch_ref.check_both(ref, "test_current_tree_lints_clean_strict")


# ---------------------------------------------------------------------------
# the port's findings equal the reference's
# ---------------------------------------------------------------------------

def _findings(res) -> list:
    return [(f.rule, f.file, f.line, f.severity, f.message, f.hint)
            for f in res.findings]


def _same(paths, **kw):
    j, t = janalysis.run_lint(paths, **kw), tanalysis.run_lint(paths, **kw)
    assert _findings(t) == _findings(j)
    assert (t.suppressed, t.baselined, t.files) == \
        (j.suppressed, j.baselined, j.files)
    return t


@pytest.mark.parametrize("fixture", FIXTURE_FILES + ["all"])
def test_fixture_findings_match_reference(fixture):
    """Every rule on each fixture file (and on all of them in one run,
    where the cross-file rules see every file): the port's findings are
    the reference's, field for field. Each bad fixture is flagged."""
    files = FIXTURE_FILES if fixture == "all" else [fixture]
    res = _same([str(FIXTURES / f) for f in files])
    if fixture != "all" and "bad" in fixture:
        assert res.errors >= 1
    if fixture == "all":
        assert {f.rule for f in res.findings} == set(ref.CASES)


def test_tree_lints_clean_with_ratchet(monkeypatch, capsys):
    """``lint --strict --ratchet lint-ratchet.json src tests`` exits 0 on
    the tree in both packages, with the same file and suppression
    counts (the committed ratchet: 2)."""
    monkeypatch.chdir(REPO)
    argv = ["--strict", "--ratchet", "lint-ratchet.json", "src", "tests"]
    assert janalysis.main(argv) == 0
    jout = capsys.readouterr().out
    assert tanalysis.main(argv) == 0
    assert capsys.readouterr().out == jout
    assert jout.startswith("repro lint: 0 error(s), 0 warning(s) across ")
    assert jout.endswith(" file(s) (2 suppressed)\n")


# ---------------------------------------------------------------------------
# the port's contract files: seeded violations in copies of them
# ---------------------------------------------------------------------------

PORT_ORCH = REPO / "src" / "repro_torch" / "orchestrator"
SEEDED_METHOD = '''
    def forget_free(self, n: int) -> None:
        for _ in range(n):
            self.free.pop()

    def check(self) -> None:'''


def _seed(tmp_path, rel: str, *edits: tuple) -> Path:
    """A copy of the repo's ``rel`` under ``tmp_path`` with each (old, new)
    edit made once."""
    src = (REPO / rel).read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(src)
    return dst


def test_span_kind_without_transitions_flagged_by_port_only(tmp_path,
                                                            monkeypatch):
    """A span kind added to the port's ``SPAN_KINDS`` (and to
    ``export_chrome``) with no ``SPAN_TRANSITIONS`` entry: exactly one
    ``span-lifecycle`` error from the port's linter, none from the JAX
    one, which reads its own table."""
    monkeypatch.chdir(REPO)
    rel = "src/repro_torch/orchestrator/obs/tracing.py"
    path = _seed(tmp_path, rel,
                 ('"evict", "reroute")', '"evict", "reroute", "park")'),
                 ('elif e.name == "reroute":\n                    events',
                  'elif e.name in ("reroute", "park"):\n                    '
                  'events'))
    t = tanalysis.run_lint([str(path)], rules=["span-lifecycle"])
    assert [(f.rule, f.severity) for f in t.findings] == \
        [("span-lifecycle", "error")]
    assert "missing ['park']" in t.findings[0].message
    assert t.findings[0].file == str(path)
    assert janalysis.run_lint([str(path)], rules=["span-lifecycle"]) \
        .findings == []
    # the unseeded copy is clean for both
    clean = tmp_path / "clean" / rel
    clean.parent.mkdir(parents=True)
    clean.write_text((REPO / rel).read_text())
    assert tanalysis.run_lint([str(clean)]).findings == []


def test_uncovered_pool_method_flagged_by_port_only(tmp_path, monkeypatch):
    """A public mutating ``PagePool`` method added to a copy of the port's
    ``page_pool.py`` that ``tests/test_page_pool.py`` never calls: the
    port's ``pool-mutation`` names it; the JAX one, which reads its own
    pool, finds nothing."""
    monkeypatch.chdir(REPO)
    rel = "src/repro_torch/orchestrator/page_pool.py"
    path = _seed(tmp_path, rel, ("\n    def check(self) -> None:",
                                 SEEDED_METHOD))
    tests = tmp_path / "tests" / "test_page_pool.py"
    tests.parent.mkdir()
    tests.write_text((REPO / "tests" / "test_page_pool.py").read_text())
    t = tanalysis.run_lint([str(path)], rules=["pool-mutation"])
    assert len(t.findings) == 1
    assert "'forget_free' is never exercised by tests/test_page_pool.py" \
        in t.findings[0].message
    assert janalysis.run_lint([str(path)], rules=["pool-mutation"]) \
        .findings == []
    # without the seeded method, the port's pool is fully covered
    assert tanalysis.run_lint([str(PORT_ORCH / "page_pool.py")],
                              rules=["pool-mutation"]).findings == []


def test_lint_runs_without_jax_and_builds_no_runtime(tmp_path):
    """``python -m repro_torch.cli lint --strict --ratchet ... src tests``
    in a process whose PYTHONPATH starts with a directory where ``import
    jax`` and ``import repro`` raise: exit 0, 0 findings, no
    ``.stevedore``."""
    poison = tmp_path / "poison"
    for name in ("jax", "repro"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable here')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(poison), str(REPO / "src")])}
    work = tmp_path / "work"
    work.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.cli", "lint", "--strict",
         "--ratchet", str(REPO / "lint-ratchet.json"), str(REPO / "src"),
         str(REPO / "tests")],
        cwd=work, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro lint: 0 error(s), 0 warning(s)" in proc.stdout
    assert "(2 suppressed)" in proc.stdout
    assert list(work.iterdir()) == []
