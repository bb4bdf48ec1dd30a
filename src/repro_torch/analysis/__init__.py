"""Static analysis for the serving stack (``repro lint``).

Pure AST + string analysis of the repo's hand-maintained contracts --
donation discipline, the single-writer metrics rule, the span-lifecycle
state machine, PagePool mutation ownership, jit capture hygiene and
tick determinism. No imports of the checked code, no jax: a full run
takes well under a second.

PyTorch port of ``repro.analysis``: the same six rules, ``lint-ok``
suppression marker, baselines and ratchet file, so both linters
honour the same suppressions and the same committed count. The rules that
read a contract file (``span-lifecycle``: the span table;
``pool-mutation``: the pool's internals) read the port's own
``src/repro_torch/orchestrator`` files, and the repo root is the nearest
ancestor holding ``src/repro_torch``.
"""

from repro_torch.analysis.core import (
    Check,
    Finding,
    LintResult,
    Project,
    all_checks,
    load_baseline,
    main,
    run_lint,
    write_baseline,
)

__all__ = ["Check", "Finding", "LintResult", "Project", "all_checks",
           "load_baseline", "main", "run_lint", "write_baseline"]
