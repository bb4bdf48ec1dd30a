"""The six project-invariant checks behind ``repro lint``.

Order here is presentation order for ``repro lint --list-rules``; each
module's docstring is the authoritative statement of its contract.
"""

from repro_torch.analysis.checks.donation import DonationCheck
from repro_torch.analysis.checks.metrics_writer import MetricsWriterCheck
from repro_torch.analysis.checks.span_lifecycle import SpanLifecycleCheck
from repro_torch.analysis.checks.pool_mutation import PoolMutationCheck
from repro_torch.analysis.checks.jit_capture import JitCaptureCheck
from repro_torch.analysis.checks.tick_determinism import TickDeterminismCheck

ALL_CHECKS = [
    DonationCheck,
    MetricsWriterCheck,
    SpanLifecycleCheck,
    PoolMutationCheck,
    JitCaptureCheck,
    TickDeterminismCheck,
]

__all__ = ["ALL_CHECKS", "DonationCheck", "MetricsWriterCheck",
           "SpanLifecycleCheck", "PoolMutationCheck", "JitCaptureCheck",
           "TickDeterminismCheck"]
