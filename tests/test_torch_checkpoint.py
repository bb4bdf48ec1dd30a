"""The port's checkpoint store, elastic restore and straggler monitor:
tests/test_checkpoint.py's invariants on the port, the paper's portability
claim applied to state (a checkpoint written by one package restores in
the other, float32, bfloat16 and int32 leaves bit for bit, blob names
equal), and tests/test_system.py's failure drill on the port's
Container."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro_torch.checkpoint.elastic import reshard_restore
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.checkpoint.straggler import StragglerMonitor
from repro_torch.core.runtime import Runtime
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.params import tree_leaves


def tree(seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": scale * torch.randn((32, 16), generator=g),
        "nested": {"b": torch.arange(8, dtype=torch.float32),
                   "step": torch.tensor(3, dtype=torch.int32)},
    }


def _equal(a, b):
    assert len(tree_leaves(a)) == len(tree_leaves(b))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    store = CheckpointStore(tmp_path)
    t = tree()
    t["half"] = torch.randn(5, 3).to(torch.bfloat16)
    store.save(10, t, blocking=True)
    _equal(t, store.restore(t, 10))


def test_latest_and_steps(tmp_path):
    store = CheckpointStore(tmp_path)
    for s in (1, 5, 3):
        store.save(s, tree(s), blocking=True)
    assert store.steps() == [1, 3, 5]
    assert store.latest_step() == 3          # LATEST points at last written


def test_blob_dedupe_across_checkpoints(tmp_path):
    store = CheckpointStore(tmp_path)
    t = tree()
    store.save(1, t, blocking=True)
    s1 = dict(store.last_stats)
    store.save(2, {**t, "w": t["w"] + 1}, blocking=True)
    s2 = dict(store.last_stats)
    assert s1["new_blobs"] == 3
    assert s2["new_blobs"] == 1 and s2["reused_blobs"] == 2
    # equal leaves inside one tree are one blob, counted once as new
    store.save(3, {"m": torch.zeros(64), "v": torch.zeros(64)},
               blocking=True)
    assert (store.last_stats["new_blobs"],
            store.last_stats["reused_blobs"]) == (1, 1)


def test_async_save_then_wait_and_snapshot_is_a_copy(tmp_path):
    store = CheckpointStore(tmp_path)
    t = tree()
    want = tree()
    store.save(7, t, blocking=False)
    t["w"].add_(1.0)                         # training goes on in place
    store.wait()
    assert store.latest_step() == 7
    _equal(want, store.restore(want, 7))


def test_gc_keeps_live_blobs(tmp_path):
    store = CheckpointStore(tmp_path)
    for s in range(5):
        store.save(s, tree(s), blocking=True)
    assert store.gc(keep_last=2) > 0
    assert store.steps() == [3, 4]
    _equal(tree(4), store.restore(tree(4), 4))


def test_keep_drops_old_checkpoints_before_a_write(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in range(4):
        store.save(s, tree(s), blocking=True)
        assert store.steps() == list(range(max(0, s - 1), s + 1))
    # the blobs on disk are exactly those of the checkpoints kept
    assert len(list((tmp_path / "blobs").iterdir())) == 2 + 2
    one = CheckpointStore(tmp_path / "one", keep=1)
    one.save(1, tree(1), blocking=True)
    one.save(1, tree(1), blocking=True)      # the same step again: reused
    assert one.last_stats["new_blobs"] == 0
    one.save(2, tree(2), blocking=True)
    assert one.steps() == [2]
    _equal(tree(2), one.restore(tree(2)))


def test_restore_shape_mismatch_raises(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, tree(), blocking=True)
    with pytest.raises(ValueError, match="shape"):
        store.restore({**tree(), "w": torch.zeros(4, 4)}, 1)


def test_elastic_reshard_restore(tmp_path):
    """Restore into a template of meta tensors: leaves cast to the
    template's dtypes and placed on the target device."""
    store = CheckpointStore(tmp_path)
    t = tree()
    store.save(1, t, blocking=True)
    tmpl = {"w": torch.empty((32, 16), dtype=torch.bfloat16, device="meta"),
            "nested": {"b": torch.empty(8, device="meta"),
                       "step": torch.empty((), dtype=torch.int32,
                                           device="meta")}}
    out = reshard_restore(store, tmpl, "cpu", 1)
    assert out["w"].dtype == torch.bfloat16 and out["w"].device.type == "cpu"
    assert torch.equal(out["w"], t["w"].to(torch.bfloat16))
    assert int(out["nested"]["step"]) == 3


# ---------------------------------------------------------------------------
# a checkpoint moves between the packages
# ---------------------------------------------------------------------------

def _mixed(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((6, 4)).astype(np.float32),
                       "h": rng.standard_normal((3, 5)).astype(np.float32)},
            "step": np.int32(9)}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    src = _mixed(0)
    jtree = {"params": {"w": jnp.asarray(src["params"]["w"]),
                        "h": jnp.asarray(src["params"]["h"],
                                         dtype=jnp.bfloat16)},
             "comm": None, "step": jnp.int32(9)}
    JStore(tmp_path).save(3, jtree, blocking=True)
    tmpl = {"params": {"w": torch.empty(6, 4, device="meta"),
                       "h": torch.empty(3, 5, dtype=torch.bfloat16,
                                        device="meta")},
            "comm": None, "step": torch.empty((), dtype=torch.int32,
                                              device="meta")}
    store = CheckpointStore(tmp_path)
    assert store.latest_step() == 3
    out = store.restore(tmpl)
    assert out["comm"] is None
    assert torch.equal(out["params"]["w"], torch.from_numpy(src["params"]["w"]))
    assert out["params"]["h"].dtype == torch.bfloat16
    bits = np.asarray(jtree["params"]["h"]).view(np.int16)
    assert np.array_equal(out["params"]["h"].view(torch.int16).numpy(), bits)
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 9


def test_port_checkpoint_restores_in_jax(tmp_path):
    src = _mixed(1)
    ttree = {"params": {"w": torch.from_numpy(src["params"]["w"]),
                        "h": torch.from_numpy(src["params"]["h"]).to(
                            torch.bfloat16)},
             "step": torch.tensor(9, dtype=torch.int32)}
    CheckpointStore(tmp_path / "t").save(5, ttree, blocking=True)
    jtmpl = {"params": {"w": jnp.zeros((6, 4)),
                        "h": jnp.zeros((3, 5), jnp.bfloat16)},
             "step": jnp.int32(0)}
    out = JStore(tmp_path / "t").restore(jtmpl)
    np.testing.assert_array_equal(out["params"]["w"], src["params"]["w"])
    # the JAX store returns bfloat16 blobs as raw 2-byte words; viewed as
    # bfloat16 they are the port's values bit for bit
    h = out["params"]["h"].view(jnp.bfloat16)
    assert np.array_equal(h.view(np.int16),
                          ttree["params"]["h"].view(torch.int16).numpy())
    assert int(out["step"]) == 9
    # the same tree saved by the JAX package: the same manifest, blob for
    # blob (the digest is of the tensor's bytes in both packages)
    JStore(tmp_path / "j").save(5, {
        "params": {"w": jnp.asarray(src["params"]["w"]),
                   "h": jnp.asarray(h)}, "step": jnp.int32(9)},
        blocking=True)
    man = [json.loads((tmp_path / d / "manifests" /
                       "step-0000000005.json").read_text())
           for d in ("t", "j")]
    assert man[0] == man[1]


# ---------------------------------------------------------------------------
# failure drill (tests/test_system.py) on the port's Container
# ---------------------------------------------------------------------------

IMAGEFILE = """
FROM scratch
ARCH llama3.2-3b-smoke
SHAPE train_4k seq_len=16 global_batch=4
MESH local
PRECISION compute=float32 params=float32
COLLECTIVES generic
SET optimizer={"lr":0.005,"warmup_steps":2,"total_steps":50}
"""


def test_node_failure_recovery_drill(tmp_path):
    """An async save in flight when the run dies: the published checkpoint
    is intact, a fresh container restores it and replays the next step
    bit for bit."""
    rt = Runtime(tmp_path / "rt")
    rt.build(IMAGEFILE, tag="stable")
    c = rt.run("stable", platform="cpu")
    p = c.init_params(0)
    o = c.init_opt_state(p)
    store = CheckpointStore(c.overlay / "ckpt")
    data = SyntheticLM(DataConfig(vocab_size=c.arch.vocab_size, seq_len=16,
                                  global_batch=4, seed=11))
    step = c.train_step_fn(donate=True)
    p, o, _ = step(p, o, data.batch(0))
    store.save(1, {"params": p, "opt": o}, blocking=False)
    p, o, _ = step(p, o, data.batch(1))     # mutates p and o in place
    store.wait()
    c2 = rt.run("stable", platform="cpu")
    t = {"params": c2.abstract_params(), "opt": c2.abstract_opt_state()}
    restored = reshard_restore(store, t, c2.device)
    assert int(restored["opt"]["step"]) == 1
    p2, _, _ = c2.train_step_fn()(restored["params"], restored["opt"],
                                  data.batch(1))
    for x, y in zip(tree_leaves(p), tree_leaves(p2)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------

def test_straggler_flags_outlier():
    mon = StragglerMonitor(window=16, trip_threshold=2)
    for _ in range(16):
        mon.observe(1.0)
    r = mon.observe(10.0)
    assert r["flagged"] and not r["tripped"]
    assert mon.observe(10.0)["tripped"]


def test_straggler_tolerates_noise():
    mon = StragglerMonitor(window=16)
    rng = np.random.default_rng(0)
    flags = sum(mon.observe(1.0 + 0.01 * rng.standard_normal())["flagged"]
                for _ in range(200))
    assert flags <= 2


def test_straggler_outliers_excluded_from_window():
    mon = StragglerMonitor(window=16, trip_threshold=99)
    for _ in range(16):
        mon.observe(1.0)
    for _ in range(10):
        assert mon.observe(5.0)["flagged"]
