"""tests/test_slo.py on the port: priority lanes, admission deadlines,
router shedding and page-level preemption in ``repro_torch`` -- strict
priority with FIFO within a class, per-lane arrival, front-of-lane
requeue, QoS field validation, a batch head shed past its deadline (its
span-log recompute equal to the live registry), the router's overload
shed and spill, the live TTFT p99 read, and preemption with its resume
(token parity with a pressure-free pod, pool invariants after every tick,
nothing lost) -- against the JAX package, on the CPU (llama3.2-3b-smoke
in float32, the JAX package's seed-0 weights).

Each port test runs the reference test's body through
``torch_ref.check_both`` (see test_torch_orchestrator.py): the body's own
assertions hold on the port, and every request (tokens, state, finish
reason, error, ticks, preemptions), every pod (counters, pool state,
metrics snapshot, spans), scheduler (sheds) and router (routed, spilled,
shed, by policy, the fleet's metrics) equals the JAX package's exactly.
"""

import pytest

import test_slo as ref
import torch_ref

pytestmark = pytest.mark.orchestrator


@pytest.fixture(scope="module")
def rts(tmp_path_factory):
    return torch_ref.runtimes(tmp_path_factory.mktemp("stevedore"),
                              ref.IMAGEFILE)


def _rt(rts):
    return lambda pkg, port: (rts[port],)


def test_lanes_strict_priority_fifo_within_class():
    """Mirrors test_slo.py::test_lanes_strict_priority_fifo_within_class."""
    torch_ref.check_both(ref, "test_lanes_strict_priority_fifo_within_class")


def test_lane_arrival_blocks_only_its_own_lane():
    """Mirrors test_slo.py::test_lane_arrival_blocks_only_its_own_lane."""
    torch_ref.check_both(ref, "test_lane_arrival_blocks_only_its_own_lane")


def test_requeue_front_of_lane_and_preempted_only():
    """Mirrors test_slo.py::test_requeue_front_of_lane_and_preempted_only."""
    torch_ref.check_both(ref, "test_requeue_front_of_lane_and_preempted_only")


def test_qos_field_validation():
    """Mirrors test_slo.py::test_qos_field_validation."""
    torch_ref.check_both(ref, "test_qos_field_validation")


def test_deadline_miss_sheds_at_admission(rts):
    """Mirrors test_slo.py::test_deadline_miss_sheds_at_admission (the
    port's ``obs.recompute_registry`` and ``completion_snapshot``)."""
    t = torch_ref.check_both(ref, "test_deadline_miss_sheds_at_admission",
                             _rt(rts))
    assert t["schedulers"][0]["shed"] == [1]


def test_router_sheds_batch_when_every_fitting_pod_overloaded(rts):
    """Mirrors test_slo.py::
    test_router_sheds_batch_when_every_fitting_pod_overloaded."""
    t = torch_ref.check_both(
        ref, "test_router_sheds_batch_when_every_fitting_pod_overloaded",
        _rt(rts))
    assert t["routers"][0]["shed"] == 1


def test_router_spills_batch_to_non_overloaded_pod_before_shedding(rts):
    """Mirrors test_slo.py::
    test_router_spills_batch_to_non_overloaded_pod_before_shedding."""
    torch_ref.check_both(
        ref, "test_router_spills_batch_to_non_overloaded_pod_before_shedding",
        _rt(rts))


def test_overloaded_reads_ttft_p99_from_live_registry(rts):
    """Mirrors test_slo.py::test_overloaded_reads_ttft_p99_from_live_registry
    (the port's ``obs.report.TICK_HIST`` geometry)."""
    torch_ref.check_both(
        ref, "test_overloaded_reads_ttft_p99_from_live_registry", _rt(rts))


def test_preemption_parity_invariants_and_zero_loss(rts):
    """Mirrors test_slo.py::test_preemption_parity_invariants_and_zero_loss."""
    t = torch_ref.check_both(
        ref, "test_preemption_parity_invariants_and_zero_loss", _rt(rts))
    assert t["pods"][0]["engines"][0]["preemptions"] >= 1


def test_interactive_head_never_preempts_interactive(rts):
    """Mirrors test_slo.py::
    test_interactive_head_never_preempts_interactive."""
    torch_ref.check_both(
        ref, "test_interactive_head_never_preempts_interactive", _rt(rts))


def test_preempted_request_resumes_across_engines(rts):
    """Mirrors test_slo.py::test_preempted_request_resumes_across_engines."""
    torch_ref.check_both(ref, "test_preempted_request_resumes_across_engines",
                         _rt(rts))
