"""tests/test_page_pool.py on the port: every PagePool + PrefixRadix
invariant of the reference suite, re-run on ``repro_torch``'s
``orchestrator.page_pool`` (its randomized schedules with ``check()``
after every operation, refcounts, the interior digest collision, LRU
eviction under pressure, the spill tier, ``pin_cost``, sharer isolation,
COW and the API guards).

Each port test runs the reference test's body twice through
``torch_ref.run_both``: as written on the JAX package, then with the
port's ``PagePool``/``PrefixMatch`` (and, for the collision, the port's
``prefix_registry.chained_digest`` patched). Besides the body's own
assertions, every pool it built must end in the same state in both
packages: page table, refcounts, free list, reservations and the
``status()`` counters (allocations, frees, evictions, COW copies, spills,
restores, radix nodes), exactly.
"""

import pytest

import test_page_pool as ref
import torch_ref

pytestmark = pytest.mark.orchestrator


def _same(name, **kw):
    assert torch_ref.check_both(ref, name, **kw)["pools"], name


def test_random_radix_schedules_conserve_pages():
    """Mirrors test_page_pool.py::test_random_radix_schedules_conserve_pages
    (800 random ops, full reclaim)."""
    _same("test_random_radix_schedules_conserve_pages")


def test_refcounts_match_table_occurrences():
    """Mirrors test_page_pool.py::test_refcounts_match_table_occurrences."""
    _same("test_refcounts_match_table_occurrences")


def test_digest_collision_at_interior_node_misses():
    """Mirrors test_page_pool.py::test_digest_collision_at_interior_node_misses
    (the forged digest patched into each package's prefix_registry)."""
    _same("test_digest_collision_at_interior_node_misses",
          needs_monkeypatch=True)


def test_eviction_under_pressure_never_frees_live_refs():
    """Mirrors
    test_page_pool.py::test_eviction_under_pressure_never_frees_live_refs."""
    _same("test_eviction_under_pressure_never_frees_live_refs")


def test_eviction_order_deterministic_on_lru_ties():
    """Mirrors test_page_pool.py::
    test_eviction_order_deterministic_on_lru_ties."""
    _same("test_eviction_order_deterministic_on_lru_ties")


def test_spill_restore_round_trip_with_io_callbacks():
    """Mirrors
    test_page_pool.py::test_spill_restore_round_trip_with_io_callbacks."""
    _same("test_spill_restore_round_trip_with_io_callbacks")


def test_spill_store_capacity_prunes_lru_subtrees():
    """Mirrors test_page_pool.py::
    test_spill_store_capacity_prunes_lru_subtrees."""
    _same("test_spill_store_capacity_prunes_lru_subtrees")


def test_pin_cost_dedupes_by_page_id():
    """Mirrors test_page_pool.py::test_pin_cost_dedupes_by_page_id."""
    _same("test_pin_cost_dedupes_by_page_id")


def test_release_one_sharer_keeps_other_sharers_pages():
    """Mirrors
    test_page_pool.py::test_release_one_sharer_keeps_other_sharers_pages."""
    _same("test_release_one_sharer_keeps_other_sharers_pages")


def test_cow_remaps_last_shared_row():
    """Mirrors test_page_pool.py::test_cow_remaps_last_shared_row."""
    _same("test_cow_remaps_last_shared_row")


def test_share_requires_clean_slot_and_nonempty_match():
    """Mirrors
    test_page_pool.py::test_share_requires_clean_slot_and_nonempty_match."""
    _same("test_share_requires_clean_slot_and_nonempty_match")


def test_garbage_page_never_cached_or_shared():
    """Mirrors test_page_pool.py::test_garbage_page_never_cached_or_shared."""
    _same("test_garbage_page_never_cached_or_shared")


def test_port_objects_are_the_ports():
    """The harness really swaps packages: on the port run the reference
    module's ``PagePool`` is the port's class, and restored after."""
    from repro.orchestrator.page_pool import PagePool as JPool
    from repro_torch.orchestrator.page_pool import PagePool as TPool
    seen = {}

    def body():
        seen["cls"] = ref.PagePool
        seen["match"] = ref.PrefixMatch
    torch_ref.run_on(ref, body, port=True)
    assert issubclass(seen["cls"], TPool) and not issubclass(seen["cls"],
                                                             JPool)
    assert seen["match"].__module__.startswith("repro_torch.")
    assert ref.PagePool is JPool


_LEAKS = {
    "module": "import repro.orchestrator.page_pool as pp\n"
              "def body():\n    pass\n",
    "instance": "from repro.orchestrator.page_pool import PagePool\n"
                "pool = object.__new__(PagePool)\n"
                "def body():\n    pass\n",
    "default argument": "from repro.orchestrator.page_pool import PagePool\n"
                        "def body(cls=PagePool):\n    pass\n",
    "body import": "def body():\n"
                   "    from repro.models.attention import _sdpa_dense\n",
}


@pytest.mark.parametrize("leak", sorted(_LEAKS))
def test_port_run_fails_on_a_jax_object(leak):
    """The harness fails a port run whose reference module still reaches
    the JAX package: a module, an instance or a default argument among its
    globals, or an import its body makes."""
    import types
    fake = types.ModuleType("fake_reference_suite")
    exec(_LEAKS[leak], vars(fake))
    with pytest.raises(AssertionError, match="JAX package"):
        torch_ref.run_on(fake, fake.body, port=True)
    torch_ref.run_on(fake, fake.body, port=False)
