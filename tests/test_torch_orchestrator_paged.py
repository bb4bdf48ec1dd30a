"""tests/test_orchestrator.py on the port, second half: the paged path
(pool-named rejections, parity with contiguous, long requests past the
old slab, pool backpressure, chunk 1 against chunk 4, span rounding,
recurrent refusal), ``ps`` state, and the admission, telemetry and
slot-engine regressions -- on ``repro_torch``, against the JAX package,
on the CPU (llama3.2-3b-smoke in float32, the JAX package's seed-0
weights). The first half, and how ``torch_ref.check_both`` holds the
two packages to each other, is in test_torch_orchestrator.py.
"""

import pytest

import test_orchestrator as ref
import torch_ref

pytestmark = pytest.mark.orchestrator


@pytest.fixture(scope="module")
def rts(tmp_path_factory):
    return torch_ref.runtimes(tmp_path_factory.mktemp("stevedore"),
                              ref.IMAGEFILE)


def _rt(rts):
    return lambda pkg, port: (rts[port],)


def test_oversized_rejection_names_pool_not_slots_when_paged(rts):
    """Mirrors test_orchestrator.py::
    test_oversized_rejection_names_pool_not_slots_when_paged."""
    torch_ref.check_both(
        ref, "test_oversized_rejection_names_pool_not_slots_when_paged",
        _rt(rts))


def test_paged_lockstep_parity_with_contiguous(rts):
    """Mirrors test_orchestrator.py::
    test_paged_lockstep_parity_with_contiguous."""
    torch_ref.check_both(ref, "test_paged_lockstep_parity_with_contiguous",
                         _rt(rts))


def test_paged_long_request_exceeds_old_slab(rts):
    """Mirrors test_orchestrator.py::
    test_paged_long_request_exceeds_old_slab."""
    torch_ref.check_both(ref, "test_paged_long_request_exceeds_old_slab",
                         _rt(rts))


def test_paged_pool_backpressure_holds_fifo_head(rts):
    """Mirrors test_orchestrator.py::
    test_paged_pool_backpressure_holds_fifo_head."""
    torch_ref.check_both(ref, "test_paged_pool_backpressure_holds_fifo_head",
                         _rt(rts))


def test_paged_chunk1_matches_chunk4(rts):
    """Mirrors test_orchestrator.py::test_paged_chunk1_matches_chunk4."""
    torch_ref.check_both(ref, "test_paged_chunk1_matches_chunk4", _rt(rts))


def test_paged_nonmultiple_max_len_rejects_instead_of_crashing(rts):
    """Mirrors test_orchestrator.py::
    test_paged_nonmultiple_max_len_rejects_instead_of_crashing."""
    torch_ref.check_both(
        ref, "test_paged_nonmultiple_max_len_rejects_instead_of_crashing",
        _rt(rts))


def test_paged_rejects_recurrent_archs(rts):
    """Mirrors test_orchestrator.py::test_paged_rejects_recurrent_archs."""
    torch_ref.check_both(ref, "test_paged_rejects_recurrent_archs", _rt(rts))


def test_pod_state_visible_to_ps(rts):
    """Mirrors test_orchestrator.py::test_pod_state_visible_to_ps."""
    torch_ref.check_both(ref, "test_pod_state_visible_to_ps", _rt(rts))


def test_oversized_head_rejected_under_full_load(rts):
    """Mirrors test_orchestrator.py::
    test_oversized_head_rejected_under_full_load."""
    torch_ref.check_both(ref, "test_oversized_head_rejected_under_full_load",
                         _rt(rts))


def test_rejection_burst_refreshes_pod_state(rts):
    """Mirrors test_orchestrator.py::
    test_rejection_burst_refreshes_pod_state."""
    torch_ref.check_both(ref, "test_rejection_burst_refreshes_pod_state",
                         _rt(rts))


def test_nearest_rank_percentiles():
    """Mirrors test_orchestrator.py::test_nearest_rank_percentiles (the
    port's ``telemetry.nearest_rank``)."""
    torch_ref.check_both(ref, "test_nearest_rank_percentiles")


def test_free_slot_positions_stay_parked(rts):
    """Mirrors test_orchestrator.py::test_free_slot_positions_stay_parked."""
    torch_ref.check_both(ref, "test_free_slot_positions_stay_parked",
                         _rt(rts))


def test_capacity_and_free_slots_exclude_draining(rts):
    """Mirrors test_orchestrator.py::
    test_capacity_and_free_slots_exclude_draining."""
    torch_ref.check_both(ref, "test_capacity_and_free_slots_exclude_draining",
                         _rt(rts))


def test_prefill_executable_count_exposed_and_bounded(rts):
    """Mirrors test_orchestrator.py::
    test_prefill_executable_count_exposed_and_bounded (one built prefill
    step per bucket: 1 for llama's pow2 buckets, 4 for mamba2's exact
    lengths)."""
    torch_ref.check_both(
        ref, "test_prefill_executable_count_exposed_and_bounded", _rt(rts))
