"""tests/test_obs.py on the port: the observability layer of
``repro_torch.orchestrator.obs`` -- the streaming histogram against
nearest-rank, the metrics registry, snapshot merges and exemplars, the
span ring buffer and its lifecycle validator, the Chrome trace export
and its validator, the span-log -> registry recompute, the TTFT/ITL
decomposition, tokens_wasted, and the ``ps``/``top`` rendering -- against
the JAX package, on the CPU (llama3.2-3b-smoke in float32, the JAX
package's seed-0 weights, for the served traces).

Each port test runs the reference test's body through
``torch_ref.check_both`` (see test_torch_orchestrator.py): the unit
bodies assert their literal values on the port's classes; the served
ones also hold every request, pod (counters, metrics snapshot, spans),
router and ``serve_continuous`` result equal to the JAX package's. The Chrome
export of the reference's synthetic span log is also compared between
the packages, event for event.
"""

import pytest

import test_obs as ref
import torch_ref
from repro.orchestrator.obs import TraceBuffer as JTraceBuffer
from repro.orchestrator.obs import decomposition as j_decomposition
from repro.orchestrator.obs import export_chrome as j_export_chrome
from repro_torch.orchestrator.obs import (TraceBuffer, decomposition,
                                          export_chrome)


@pytest.fixture(scope="module")
def rts(tmp_path_factory):
    return torch_ref.runtimes(tmp_path_factory.mktemp("stevedore"),
                              ref.IMAGEFILE)


def _rt(rts):
    return lambda pkg, port: (rts[port],)


def test_histogram_percentile_matches_nearest_rank():
    """Mirrors test_obs.py::
    test_histogram_percentile_matches_nearest_rank
    (the hypothesis property, drawn anew on the port)."""
    torch_ref.check_both(ref, "test_histogram_percentile_matches_nearest_rank")


def test_histogram_percentile_matches_nearest_rank_fixed():
    """Mirrors test_obs.py::
    test_histogram_percentile_matches_nearest_rank_fixed."""
    torch_ref.check_both(
        ref, "test_histogram_percentile_matches_nearest_rank_fixed")


def test_histogram_empty_overflow_and_validation():
    """Mirrors test_obs.py::test_histogram_empty_overflow_and_validation."""
    torch_ref.check_both(ref, "test_histogram_empty_overflow_and_validation")


def test_histogram_snapshot_roundtrip_and_merge():
    """Mirrors test_obs.py::test_histogram_snapshot_roundtrip_and_merge."""
    torch_ref.check_both(ref, "test_histogram_snapshot_roundtrip_and_merge")


def test_registry_labels_totals_and_snapshot_determinism():
    """Mirrors test_obs.py::
    test_registry_labels_totals_and_snapshot_determinism."""
    torch_ref.check_both(
        ref, "test_registry_labels_totals_and_snapshot_determinism")


def test_merge_snapshots_and_snapshot_readers():
    """Mirrors test_obs.py::test_merge_snapshots_and_snapshot_readers."""
    torch_ref.check_both(ref, "test_merge_snapshots_and_snapshot_readers")


def test_merge_snapshots_mismatched_labels_and_empty_pods():
    """Mirrors test_obs.py::
    test_merge_snapshots_mismatched_labels_and_empty_pods."""
    torch_ref.check_both(
        ref, "test_merge_snapshots_mismatched_labels_and_empty_pods")


def test_merge_snapshots_geometry_mismatch_raises():
    """Mirrors test_obs.py::test_merge_snapshots_geometry_mismatch_raises."""
    torch_ref.check_both(ref, "test_merge_snapshots_geometry_mismatch_raises")


def test_exemplar_min_combine_is_order_independent():
    """Mirrors test_obs.py::test_exemplar_min_combine_is_order_independent."""
    torch_ref.check_both(ref, "test_exemplar_min_combine_is_order_independent")


def test_exemplar_at_follows_nearest_rank_bucket():
    """Mirrors test_obs.py::test_exemplar_at_follows_nearest_rank_bucket."""
    torch_ref.check_both(ref, "test_exemplar_at_follows_nearest_rank_bucket")


def test_exemplar_snapshot_roundtrip_and_legacy_snapshots():
    """Mirrors test_obs.py::
    test_exemplar_snapshot_roundtrip_and_legacy_snapshots."""
    torch_ref.check_both(
        ref, "test_exemplar_snapshot_roundtrip_and_legacy_snapshots")


def test_snapshot_exemplar_merges_across_labels():
    """Mirrors test_obs.py::test_snapshot_exemplar_merges_across_labels."""
    torch_ref.check_both(ref, "test_snapshot_exemplar_merges_across_labels")


def test_latency_summary_carries_count():
    """Mirrors test_obs.py::test_latency_summary_carries_count."""
    torch_ref.check_both(ref, "test_latency_summary_carries_count")


def test_itl_milliticks_edges():
    """Mirrors test_obs.py::test_itl_milliticks_edges."""
    torch_ref.check_both(ref, "test_itl_milliticks_edges")


def test_trace_buffer_ring_and_validation():
    """Mirrors test_obs.py::test_trace_buffer_ring_and_validation."""
    torch_ref.check_both(ref, "test_trace_buffer_ring_and_validation")


def test_validate_span_log_accepts_legal_lifecycles():
    """Mirrors test_obs.py::test_validate_span_log_accepts_legal_lifecycles."""
    torch_ref.check_both(
        ref, "test_validate_span_log_accepts_legal_lifecycles")


def test_validate_span_log_rejects_illegal_transitions():
    """Mirrors test_obs.py::
    test_validate_span_log_rejects_illegal_transitions."""
    torch_ref.check_both(
        ref, "test_validate_span_log_rejects_illegal_transitions")


def test_decomposition_and_recompute_from_synthetic_spans():
    """Mirrors test_obs.py::
    test_decomposition_and_recompute_from_synthetic_spans."""
    torch_ref.check_both(
        ref, "test_decomposition_and_recompute_from_synthetic_spans")


def test_validator_requires_dur_on_complete_events():
    """Mirrors test_obs.py::test_validator_requires_dur_on_complete_events."""
    torch_ref.check_both(ref, "test_validator_requires_dur_on_complete_events")


def test_single_token_completions_excluded_from_itl_percentiles():
    """Mirrors test_obs.py::
    test_single_token_completions_excluded_from_itl_percentiles."""
    torch_ref.check_both(
        ref, "test_single_token_completions_excluded_from_itl_percentiles")


def test_export_chrome_valid_and_validator_catches_corruption(tmp_path):
    """Mirrors test_obs.py::
    test_export_chrome_valid_and_validator_catches_corruption."""
    torch_ref.check_both(
        ref, "test_export_chrome_valid_and_validator_catches_corruption",
        kwargs={"tmp_path": tmp_path})


def test_synthetic_span_log_exports_equal_the_jax_packages():
    """The reference's synthetic span log (test_obs.py::_synthetic_buffer)
    recorded into each package's TraceBuffer: the Chrome exports are
    equal event for event, and so are the decompositions."""
    def build(cls):
        seen = {}

        def body():
            seen["buf"] = ref._synthetic_buffer()
        torch_ref.run_on(ref, body, port=cls is TraceBuffer)
        assert isinstance(seen["buf"], cls)
        return seen["buf"]
    jbuf, tbuf = build(JTraceBuffer), build(TraceBuffer)
    assert export_chrome([tbuf]) == j_export_chrome([jbuf])
    assert decomposition([tbuf]) == j_decomposition([jbuf])


@pytest.mark.orchestrator
def test_span_lifecycle_invariants_and_recompute_match(rts):
    """Mirrors test_obs.py::
    test_span_lifecycle_invariants_and_recompute_match."""
    t = torch_ref.check_both(
        ref, "test_span_lifecycle_invariants_and_recompute_match", _rt(rts))
    assert len(t["requests"]) == 19


@pytest.mark.orchestrator
def test_tokens_wasted_counts_chunk_overshoot(rts):
    """Mirrors test_obs.py::test_tokens_wasted_counts_chunk_overshoot."""
    torch_ref.check_both(ref, "test_tokens_wasted_counts_chunk_overshoot",
                         _rt(rts))


@pytest.mark.orchestrator
def test_pod_trace_exports_valid_chrome_json(rts, tmp_path):
    """Mirrors test_obs.py::test_pod_trace_exports_valid_chrome_json (the
    port's ``obs.validate`` CLI)."""
    torch_ref.check_both(ref, "test_pod_trace_exports_valid_chrome_json",
                         _rt(rts), kwargs={"tmp_path": tmp_path})


@pytest.mark.orchestrator
def test_router_policy_counters_and_ps_rendering(rts):
    """Mirrors test_obs.py::test_router_policy_counters_and_ps_rendering
    (the port's ``cli ps``)."""
    t = torch_ref.check_both(
        ref, "test_router_policy_counters_and_ps_rendering", _rt(rts))
    assert t["routers"][0]["spilled"] == 1


@pytest.mark.orchestrator
def test_top_renders_live_metrics(rts):
    """Mirrors test_obs.py::test_top_renders_live_metrics (the port's
    ``cli top``)."""
    torch_ref.check_both(ref, "test_top_renders_live_metrics", _rt(rts))


@pytest.mark.orchestrator
def test_serve_trace_flag_writes_valid_trace(rts, tmp_path):
    """Mirrors test_obs.py::test_serve_trace_flag_writes_valid_trace (the
    port's ``serve_continuous`` with a trace path)."""
    t = torch_ref.check_both(ref, "test_serve_trace_flag_writes_valid_trace",
                             _rt(rts), kwargs={"tmp_path": tmp_path})
    assert t["serves"][0]["latency_count"] == 5
