"""tests/test_core_runtime.py on the port: the Runtime facade, Container
overlays and metrics, the CompileCache, and the data pipeline's
determinism in ``repro_torch``, against the JAX package, on the CPU.

The overlay, metrics-log and data-pipeline tests run the reference
test's body through ``torch_ref.check_both`` (see
test_torch_orchestrator.py); the data tests also hold the port's batches
equal to the JAX package's. The JAX package's CompileCache keeps jitted
XLA executables (L1) and lowered StableHLO text (L2); the port builds
eager steps, so its cache is one in-memory level of built callables,
keyed by image sections, step kind with shapes, device and torch
version. The three cache tests are written out for that cache (ROADMAP
Queue 3, "Reference behaviour the port mirrors or adapts"), and the
train-step test runs the port's ``train_step_fn`` where the reference
``jax.jit``s its own: its loss equals the JAX package's on the same
weights within 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_core_runtime as ref
import torch_ref
from repro.core.runtime import Runtime as JRuntime
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import MemmapLM as JMemmapLM
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.runtime import Runtime
from repro_torch.data.pipeline import DataConfig, MemmapLM, SyntheticLM


@pytest.fixture()
def rts(tmp_path):
    """The reference's function-scoped ``rt``, in each package."""
    return {False: JRuntime(tmp_path / "jax"),
            True: Runtime(tmp_path / "torch")}


def _rt(rts):
    return lambda pkg, port: (rts[port],)


def test_runtime_build_run_train(rts):
    """Mirrors test_core_runtime.py::test_runtime_build_run_train: build,
    run, init params and optimizer state, one train step on zeros; the loss
    is finite and equals the JAX package's (its jitted step, the same
    weights) within 1e-4; the overlay records the image; ``ps`` lists the
    container's arch."""
    jrt, rt = rts[False], rts[True]
    jrt.build(ref.SMOKE_IMAGEFILE, tag="smoke")
    jc = jrt.run("smoke")
    jparams = jc.init_params(0)
    batch = {"tokens": jnp.zeros((2, 16), jnp.int32),
             "labels": jnp.zeros((2, 16), jnp.int32)}
    np_params = jax.tree.map(np.asarray, jparams)
    _, _, jm = jax.jit(jc.train_step_fn())(jparams,
                                           jc.init_opt_state(jparams), batch)

    img = rt.build(ref.SMOKE_IMAGEFILE, tag="smoke")
    c = rt.run("smoke", platform="cpu")
    prm = c.load_params(np_params)
    opt = c.init_opt_state(prm)
    tbatch = {k: torch.zeros((2, 16), dtype=torch.long) for k in batch}
    _, _, metrics = c.train_step_fn()(prm, opt, tbatch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    assert abs(loss - float(jm["loss"])) <= 1e-4
    meta = json.loads((c.overlay / "container.json").read_text())
    assert meta["image"] == img.digest
    assert rt.ps()[0]["arch"] == "llama3.2-3b-smoke"


def test_containers_share_image_but_not_overlay(rts):
    """Mirrors test_core_runtime.py::
    test_containers_share_image_but_not_overlay."""
    torch_ref.check_both(ref, "test_containers_share_image_but_not_overlay",
                         _rt(rts))


def test_container_metrics_log(rts):
    """Mirrors test_core_runtime.py::test_container_metrics_log (a jnp
    scalar and a float logged through the port's container)."""
    torch_ref.check_both(ref, "test_container_metrics_log", _rt(rts))


def test_compile_cache_levels(tmp_path):
    """test_core_runtime.py::test_compile_cache_levels on the port's cache:
    the first build of a serve step is a miss at level L0, the same step
    for a second container of the image an L1 hit that returns the same
    built step (quicker than the build), and the step computes what a
    fresh build does."""
    rt = Runtime(tmp_path / "torch")
    rt.build(ref.SMOKE_IMAGEFILE, tag="smoke")
    shapes = dict(batch=2, prompt_len=16, cache_len=16)
    c = rt.run("smoke", platform="cpu")
    cold = c.compile_serve_step("prefill", **shapes)
    stats = rt.compile_cache.stats
    assert stats.misses == 1 and stats.last_level == "L0"
    cold_s = stats.last_seconds
    c2 = rt.run("smoke", platform="cpu")
    warm = c2.compile_serve_step("prefill", **shapes)
    assert stats.hits_l1 == 1 and stats.last_level == "L1"
    assert stats.last_seconds < cold_s and warm is cold
    assert c2.serve_compile_stats["prefill"]["hits"] == 1
    params = c.init_params(0)
    toks = torch.zeros((2, 16), dtype=torch.long)
    got, _ = warm(params, toks)
    want, _ = c.build_serve_step("prefill", **shapes)(params, toks)
    assert torch.equal(got, want)


def test_compile_cache_key_separates_configs():
    """test_core_runtime.py::test_compile_cache_key_separates_configs on the
    port's key (image digest, step kind, device): each differing field
    gives a different key, equal fields the same one."""
    cache = CompileCache()
    k1 = cache.key(image_digest="a" * 64, step_kind="train", device="cpu")
    k2 = cache.key(image_digest="b" * 64, step_kind="train", device="cpu")
    k3 = cache.key(image_digest="a" * 64, step_kind="decode", device="cpu")
    k4 = cache.key(image_digest="a" * 64, step_kind="train",
                   device="cuda:0")
    assert len({k1, k2, k3, k4}) == 4
    assert k1 == cache.key(image_digest="a" * 64, step_kind="train",
                           device=torch.device("cpu"))


def test_compile_cache_lowered_text_persisted():
    """test_core_runtime.py::test_compile_cache_lowered_text_persisted has
    no counterpart level in the port (no lowering, no L2): what a key
    holds is the built step itself, kept until evicted, and a second level
    is never reported."""
    cache = CompileCache()
    key = cache.key(image_digest="c" * 64, step_kind="t", device="cpu")
    step = cache.get_or_build(key, lambda: (lambda v: v * 2))
    assert cache.has(key) and step(torch.tensor(2.0)) == 4.0
    assert cache.get_or_build(key, lambda: None) is step
    assert cache.stats.hits_l2 == 0 and cache.stats.hits_l1 == 1
    cache.evict(key)
    assert not cache.has(key)


def test_synthetic_deterministic_and_restartable():
    """Mirrors test_core_runtime.py::
    test_synthetic_deterministic_and_restartable;
    the port's batch 5 equals the JAX package's."""
    torch_ref.check_both(ref, "test_synthetic_deterministic_and_restartable")
    kw = dict(vocab_size=100, seq_len=8, global_batch=4, seed=1)
    got = SyntheticLM(DataConfig(**kw)).batch(5)
    want = JSyntheticLM(JDataConfig(**kw)).batch(5)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_differs_across_steps_and_seeds():
    """Mirrors test_core_runtime.py::
    test_synthetic_differs_across_steps_and_seeds;
    the port's batches of both seeds equal the JAX package's."""
    torch_ref.check_both(ref, "test_synthetic_differs_across_steps_and_seeds")
    for seed in (1, 2):
        kw = dict(vocab_size=1000, seq_len=32, global_batch=2, seed=seed)
        for step in (0, 1):
            np.testing.assert_array_equal(
                SyntheticLM(DataConfig(**kw)).batch(step)["tokens"],
                JSyntheticLM(JDataConfig(**kw)).batch(step)["tokens"])


def test_memmap_source_roundtrip(tmp_path):
    """Mirrors test_core_runtime.py::test_memmap_source_roundtrip; shards
    written by the port read back in the JAX package as the same batches."""
    torch_ref.check_both(ref, "test_memmap_source_roundtrip",
                         kwargs={"tmp_path": tmp_path})
    cfg = dict(vocab_size=50, seq_len=16, global_batch=4)
    got, want = MemmapLM(DataConfig(**cfg), tmp_path), \
        JMemmapLM(JDataConfig(**cfg), tmp_path)
    for step in (0, 3):
        np.testing.assert_array_equal(got.batch(step)["tokens"],
                                      want.batch(step)["tokens"])
