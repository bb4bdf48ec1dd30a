"""Entry point for fabric worker processes.

A separate module (rather than ``-m repro_torch.orchestrator.fabric``)
because the orchestrator package imports
:mod:`repro_torch.orchestrator.fabric` at init: executing that same module
as ``__main__`` would shadow it in ``sys.modules`` and trip runpy's
double-import warning. This shim is imported by nothing, so it is always
clean to run::

    python -m repro_torch.orchestrator.fabric_worker --worker --config '<json>'

PyTorch port of ``repro.orchestrator.fabric_worker``.
"""

from repro_torch.orchestrator.fabric import main

if __name__ == "__main__":
    raise SystemExit(main())
