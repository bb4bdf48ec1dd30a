"""tests/test_prefix_serving.py on the port: the copy-on-write prefix page
cache through the paged serving stack of ``repro_torch`` -- token parity
with the cache on and off, hit accounting, the warm cache, replica
affinity, the engine-level digest collision, the whole-prompt and
sub-page edges, eviction under pressure, the chunked attention's suffix
offset, and ``serve --prefix-cache`` through ``serve_continuous`` and
the CLI -- against the JAX package, on the CPU (llama3.2-3b-smoke in
float32, the JAX package's seed-0 weights).

Each port test runs the reference test's body through
``torch_ref.check_both`` (see test_torch_orchestrator.py): the body's own
assertions hold on the port, and every request's tokens, every pod's
counters, pool state, metrics and spans, and every ``serve_continuous``
result (request tokens, prefill positions, hits, tokens saved, latency
ticks) equal the JAX package's exactly. The chunked-attention test calls
the JAX package's ``_sdpa_chunked`` on numpy arrays, so its port test is
written out against the port's ``_sdpa_chunked``/``_sdpa_dense``.
"""

import math

import numpy as np
import pytest
import torch

import test_prefix_serving as ref
import torch_ref
from repro.models.attention import _sdpa_dense as j_sdpa_dense
from repro_torch.models.attention import _sdpa_chunked, _sdpa_dense

pytestmark = pytest.mark.orchestrator


@pytest.fixture(scope="module")
def rts(tmp_path_factory):
    return torch_ref.runtimes(tmp_path_factory.mktemp("stevedore"),
                              ref.IMAGEFILE)


def _rt(rts):
    return lambda pkg, port: (rts[port],)


def test_cache_on_off_token_parity_with_hits(rts):
    """Mirrors test_prefix_serving.py::
    test_cache_on_off_token_parity_with_hits."""
    t = torch_ref.check_both(ref, "test_cache_on_off_token_parity_with_hits",
                             _rt(rts))
    assert t["pods"][1]["engines"][0]["prefix_hits"] == 5


def test_hits_skip_prefill_positions(rts):
    """Mirrors test_prefix_serving.py::test_hits_skip_prefill_positions."""
    torch_ref.check_both(ref, "test_hits_skip_prefill_positions", _rt(rts))


def test_warm_cache_survives_completion_and_rehits(rts):
    """Mirrors test_prefix_serving.py::
    test_warm_cache_survives_completion_and_rehits."""
    torch_ref.check_both(ref, "test_warm_cache_survives_completion_and_rehits",
                         _rt(rts))


def test_replica_prefix_affinity_within_pod(rts):
    """Mirrors test_prefix_serving.py::
    test_replica_prefix_affinity_within_pod."""
    torch_ref.check_both(ref, "test_replica_prefix_affinity_within_pod",
                         _rt(rts))


def test_digest_collision_at_engine_misses_and_stays_correct(rts):
    """Mirrors test_prefix_serving.py::
    test_digest_collision_at_engine_misses_and_stays_correct (the forged
    digest patched into each package's prefix_registry)."""
    torch_ref.check_both(
        ref, "test_digest_collision_at_engine_misses_and_stays_correct",
        _rt(rts), needs_monkeypatch=True)


def test_whole_prompt_equals_prefix_keeps_one_suffix_token(rts):
    """Mirrors test_prefix_serving.py::
    test_whole_prompt_equals_prefix_keeps_one_suffix_token."""
    torch_ref.check_both(
        ref, "test_whole_prompt_equals_prefix_keeps_one_suffix_token",
        _rt(rts))


def test_promotion_never_caches_unreachable_pages(rts):
    """Mirrors test_prefix_serving.py::
    test_promotion_never_caches_unreachable_pages."""
    torch_ref.check_both(ref, "test_promotion_never_caches_unreachable_pages",
                         _rt(rts))


def test_sub_page_prefix_never_caches(rts):
    """Mirrors test_prefix_serving.py::test_sub_page_prefix_never_caches."""
    torch_ref.check_both(ref, "test_sub_page_prefix_never_caches", _rt(rts))


def test_eviction_under_serving_pressure_keeps_parity(rts):
    """Mirrors test_prefix_serving.py::
    test_eviction_under_serving_pressure_keeps_parity."""
    torch_ref.check_both(
        ref, "test_eviction_under_serving_pressure_keeps_parity", _rt(rts))


def test_chunked_attend_honors_suffix_position_offset():
    """Mirrors test_prefix_serving.py::
    test_chunked_attend_honors_suffix_position_offset on the port's
    ``_sdpa_chunked``: with the suffix offset threaded through it matches
    the dense path (3e-5, the reference's bound), and the dense path
    matches the JAX package's (1e-5); ignoring the offset drops visible
    prefix chunks."""
    rng = np.random.default_rng(23)
    B, Hkv, G, hd = 1, 2, 2, 16
    L, S = 96, 8
    scale = 1.0 / math.sqrt(hd)
    q = rng.standard_normal((B, S, Hkv, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, L + S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, L + S, Hkv, hd)).astype(np.float32)
    q_pos = (L + np.arange(S))[None, :]
    k_pos = np.arange(L + S)[None, :]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tqp, tkp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    dense = _sdpa_dense(tq, tk, tv, tqp, tkp, 0, scale).numpy()
    good = _sdpa_chunked(tq, tk, tv, tqp, tkp, 0, scale, torch.float32,
                         q_chunk=16, kv_chunk=32, q_offset=L).numpy()
    np.testing.assert_allclose(good, dense, atol=3e-5)
    jdense = np.asarray(j_sdpa_dense(q, k, v, q_pos, k_pos, 0, scale))
    np.testing.assert_allclose(dense, jdense, atol=1e-5)
    wrong = _sdpa_chunked(tq, tk, tv, tqp, tkp, 0, scale, torch.float32,
                          q_chunk=16, kv_chunk=32, q_offset=0).numpy()
    assert not np.allclose(wrong, dense), \
        "0-based skipping should have dropped visible prefix chunks"


def test_cli_serve_prefix_cache_forwards_page_size(rts, capsys):
    """Mirrors test_prefix_serving.py::
    test_cli_serve_prefix_cache_forwards_page_size (the port's
    ``repro_torch.cli``: serve, then ps)."""
    t = torch_ref.check_both(
        ref, "test_cli_serve_prefix_cache_forwards_page_size", _rt(rts),
        kwargs={"capsys": capsys})
    assert t["serves"][0]["prefix_cache"]["hits"] == 3


def test_serve_driver_prefix_cache_parity(rts):
    """Mirrors test_prefix_serving.py::test_serve_driver_prefix_cache_parity
    (the port's ``launch.serve.serve_continuous``, cold and warm)."""
    t = torch_ref.check_both(ref, "test_serve_driver_prefix_cache_parity",
                             _rt(rts))
    assert len(t["serves"]) == 2
