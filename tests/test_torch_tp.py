"""Tensor and expert parallelism on the port (a ``model`` mesh axis above
1) against the JAX package's step over the same (data, model) mesh, on
the CPU.

The port's ranks are gloo processes (``tests/torch_dist_worker.py``: 4
ranks, then 2; ``jax`` and ``repro`` unimportable in them); the JAX side
is ``tests/torch_dist_jax.py`` in a subprocess whose XLA sees 4 host
devices and builds ``Model(cfg, tp, constrain, moe_mesh)`` and
``TrainStepBuilder`` over ``jax.make_mesh``. Both start from the JAX
package's seed-0 weights for the same ``tp`` (padded shapes included) as
numpy, take the same 3 global batches of 8 x 16 tokens, and run 3 steps.
One module fixture spawns each world once.

Scenarios: llama3.2-3b-smoke at (data 2, model 2) under ``generic``,
``host`` (ZeRO-1) and ``host mode=explicit`` (bf16 and float32 wires);
its ``n_heads=6`` variant at (1, 4) -- q heads padded 6 -> 8, kv heads
replicated 2 -> 4; moonshot-v1-16b-a3b-smoke at (2, 2) with
``capacity_factor=0.5``, at which the expert-parallel dispatch drops
assignments by a capacity per data shard.

Tolerances, those of tests/test_torch_dist.py: loss and grad_norm within
FP32_TOL = 1e-5 relative (the runs show 1.2e-7 and 4.3e-7 at most),
every leaf of the final params and of the first step's gradient within
PARAM_TOL = 3e-5 relative L2 (2.7e-6 and 9.5e-7); the bf16 wire
BF16_TOL = 2e-3 and BF16_PARAM_TOL = 1e-2 (9.6e-8 and 2.2e-5). The
port's (1, 2) and (1, 4) runs equal its own one-process run at the same
padded geometry: losses and grad norms within FP32_TOL, params within
PARAM_TOL (test_tp_ranks_equal_one_process says why not FP32_TOL).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro.core.runtime import Runtime as JRuntime
from repro.models.params import materialize as j_materialize
from repro.models.transformer import Model as JModel
from repro_torch.checkpoint.elastic import reshard_restore
from repro_torch.checkpoint.store import (CheckpointStore, _flatten,
                                          _unflatten)
from repro_torch.core.runtime import Runtime
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.mesh import PlatformMesh
from repro_torch.dist.sharding import (ModelAxis, NamedSharding,
                                       ShardingRules, def_shardings)
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import resolve_geometry
from repro_torch.models.transformer import Model
from repro_torch.train.train_step import TrainStepBuilder

from test_torch_dist import (_close, _flat, _leaves_close, _norm, _poison,
                             _spawn, _steps_close, _wait)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import tp_wire_bytes  # noqa: E402

FP32_TOL = 1e-5
PARAM_TOL = 3e-5
BF16_TOL = 2e-3
BF16_PARAM_TOL = 1e-2
STEPS = 3
B, S = 8, 16

IMAGEFILE = """
FROM scratch
ARCH {arch}
SHAPE train_4k seq_len=16 global_batch=8
MESH local
PRECISION compute=float32 params=float32
COLLECTIVES {collectives}
SET optimizer={{"lr":0.005,"warmup_steps":2,"total_steps":50}}{extra}
"""
LLAMA = "llama3.2-3b-smoke"
# llama3.2-3b-smoke's reduction (configs' ``reduced``) with 6 q heads: a
# ``-smoke`` arch takes its overrides before the reduction sets the heads
PADDED = ("llama3.2-3b n_layers=2 d_model=64 n_heads=6 n_kv_heads=2 "
          "head_dim=16 d_ff=128 vocab_size=256")
MOE = "moonshot-v1-16b-a3b-smoke capacity_factor=0.5"
EXPLICIT = "host mode=explicit"
EXPLICIT_F32 = "host mode=explicit grad_compression=float32"


def _image(arch, collectives="generic", extra=""):
    return IMAGEFILE.format(arch=arch, collectives=collectives, extra=extra)


def _sc(name, arch, shape, weights, collectives="generic", extra="", **kw):
    return {"name": name, "imagefile": _image(arch, collectives, extra),
            "shape": list(shape), "weights": weights, **kw}


# (weights key) -> (arch, the tp its geometry is padded for)
WEIGHTS = {"l2": (LLAMA, 2), "l4": (LLAMA, 4), "pad": (PADDED, 4),
           "m2": (MOE, 2), "m4": (MOE, 4)}
HELD = [  # held to the JAX step over the same mesh
    _sc("llama_generic", LLAMA, (2, 2), "l2", grads=True),
    _sc("llama_host", LLAMA, (2, 2), "l2", "host", ckpt=True),
    _sc("llama_explicit_f32", LLAMA, (2, 2), "l2", EXPLICIT_F32),
    _sc("llama_explicit", LLAMA, (2, 2), "l2", EXPLICIT),
    _sc("padded", PADDED, (1, 4), "pad", grads=True),
    _sc("moe", MOE, (2, 2), "m2", grads=True),
]
PLAN = {"tp": {
    "steps": STEPS,
    "jax": HELD,
    "world4": HELD + [_sc("llama_14", LLAMA, (1, 4), "l4"),
                      _sc("moe_14", MOE, (1, 4), "m4")],
    "world2": [_sc("llama_12", LLAMA, (1, 2), "l2"),
               _sc("llama_12_remat", LLAMA, (1, 2), "l2",
                   extra=" remat=full"),
               _sc("moe_12", MOE, (1, 2), "m2"),
               _sc("llama_21", LLAMA, (2, 1), "l2"),
               _sc("llama_21_host", LLAMA, (2, 1), "l2", "host")],
}}
ONE_PROCESS = {"llama_12": ("l2", 2), "llama_14": ("l4", 4),
               "moe_12": ("m2", 2), "moe_14": ("m4", 4)}


def _jax_weights(arch: str, tp: int) -> dict:
    """The JAX package's seed-0 init of ``arch`` at ``tp``'s geometry."""
    name, *kv = arch.split()
    from repro.configs import get_config
    overrides = {k: json.loads(v) for k, v in (x.split("=") for x in kv)}
    cfg = get_config(name, **overrides)
    return _flat(j_materialize(JModel(cfg, tp=tp).param_defs(),
                               jax.random.key(0), jnp.float32))


def _one_process(work: Path, weights: str, tp: int, batches) -> dict:
    """The generic ABI's 3 steps in this process at ``tp``'s padded
    geometry (a ``Model`` bound to ``tp`` without a model axis)."""
    arch, _ = WEIGHTS[weights]
    rt = Runtime(work / f"one-{weights}")
    c = rt.run(rt.build(_image(arch)), platform="cpu")
    model = Model(c.arch, tp=tp, act_dtype=torch.float32)
    with np.load(work / f"params-{weights}.npz") as z:
        params = _unflatten(model.param_defs(), {
            k: torch.from_numpy(v) for k, v in z.items()})
    step = TrainStepBuilder(model=model, abi=c.abi, opt=c.opt).build()
    from repro_torch.train.optimizer import adamw_init
    opt, rec = adamw_init(params), []
    for b in batches:
        params, opt, m = step(params, opt, b)
        rec.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
    return {"steps": rec, "params": {k: v.numpy()
                                     for k, v in _flatten(params)}}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    (work / "plan.json").write_text(json.dumps(PLAN))
    for key, (arch, tp) in WEIGHTS.items():
        np.savez(work / f"params-{key}.npz", **_jax_weights(arch, tp))
    data = SyntheticLM(DataConfig(vocab_size=256, seq_len=S, global_batch=B,
                                  seed=5))
    batches = [data.batch(i) for i in range(STEPS)]
    for i, b in enumerate(batches):
        np.savez(work / f"batch{i}.npz", **b)

    src = str(ROOT / "src")
    port_env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(_poison(work / "poison")), src]), "OMP_NUM_THREADS": "1"}
    jax_env = {**os.environ, "PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                            "--xla_disable_hlo_passes=all-reduce-promotion"}
    jproc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_jax.py"),
         str(work)], env=jax_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait(_spawn("tp4", 4, work, port_env), "4 ranks")
        _wait(_spawn("tp2", 2, work, port_env), "2 ranks")
    finally:
        _wait([jproc], "the JAX side")
    one = {name: _one_process(work, w, tp, batches)
           for name, (w, tp) in ONE_PROCESS.items()}
    arrays = {}
    for f in ("tp4.npz", "tp2.npz", "jax.npz"):
        with np.load(work / f) as z:
            arrays[f] = {k: z[k] for k in z.files}
    return {"work": work, "batches": batches, "one": one,
            "port": {**json.loads((work / "tp4.json").read_text()),
                     **json.loads((work / "tp2.json").read_text())},
            "jax": json.loads((work / "jax.json").read_text()),
            "port_arrays": {**arrays["tp4.npz"], **arrays["tp2.npz"]},
            "jax_arrays": arrays["jax.npz"]}


def _pick(arrays: dict, prefix: str) -> dict:
    """The final params of the scenario ``prefix`` names, by path."""
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix) and not k.startswith(prefix + "grad/")}


# ---------------------------------------------------------------------------
# the port's ranks against the JAX step over the same mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,tol,ptol", [
    ("llama_generic", FP32_TOL, PARAM_TOL),
    ("llama_host", FP32_TOL, PARAM_TOL),
    ("llama_explicit_f32", FP32_TOL, PARAM_TOL),
    ("llama_explicit", BF16_TOL, BF16_PARAM_TOL),
    ("padded", FP32_TOL, PARAM_TOL),
    ("moe", FP32_TOL, PARAM_TOL)])
def test_tp_training_matches_jax(tp_runs, name, tol, ptol):
    """Losses and grad norms of 3 steps, and every leaf of the final
    params, against the JAX step over the same (data, model) mesh."""
    _steps_close(tp_runs["jax"][name]["steps"],
                 tp_runs["port"][name]["steps"], tol)
    _leaves_close(_pick(tp_runs["jax_arrays"], name + "/"),
                  _pick(tp_runs["port_arrays"], name + "/"), ptol)


@pytest.mark.parametrize("name", ["llama_generic", "padded", "moe"])
def test_tp_gradients_match_jax(tp_runs, name):
    """Every leaf's gradient of the first step (the global batch's, at the
    initial weights): the replicated leaves (``wk``, ``wv``, the router,
    the norms) included, whose gradient each rank's region adds a part
    of."""
    prefix = f"{name}/grad/"
    want = {k[len(prefix):]: v for k, v in tp_runs["jax_arrays"].items()
            if k.startswith(prefix)}
    got = {k[len(prefix):]: v for k, v in tp_runs["port_arrays"].items()
           if k.startswith(prefix)}
    assert any("wk" in k for k in want) and len(want) == len(got)
    _leaves_close(want, got, PARAM_TOL)


@pytest.mark.parametrize("name", sorted(ONE_PROCESS))
def test_tp_ranks_equal_one_process(tp_runs, name):
    """(1, 2) and (1, 4) equal the port's own one-process run at the same
    padded geometry (for the MoE one data replica's capacity per shard is
    the global one): losses and grad norms within FP32_TOL, final params
    within PARAM_TOL. The ranks sum each region's partial outputs and
    input gradients over the axis where one process sums them in one
    product, a rounding apart; Adam divides each gradient element by its
    own RMS and so carries that rounding to a share of the learning rate
    where a gradient is near zero. The embeddings of the MoE runs (init
    std 0.02) show it most: moe_14's ``embed.tokens`` 1.14e-5 relative
    L2 (max 3.0e-5 absolute against lr 5e-3), moe_12's 7.6e-6; every
    other leaf of the four runs is within 3.7e-6, and losses within
    1.2e-7, grad norms within 5.6e-7."""
    one = tp_runs["one"][name]
    _steps_close(one["steps"], tp_runs["port"][name]["steps"], FP32_TOL)
    _leaves_close(one["params"], _pick(tp_runs["port_arrays"], name + "/"),
                  PARAM_TOL)


def test_moe_capacity_is_per_data_shard(tp_runs):
    """At (2, 2) and capacity factor 0.5 the dispatch drops assignments,
    by a capacity of each data shard's tokens: the run differs from one
    process's over the global batch, and matches JAX's
    (test_tp_training_matches_jax[moe])."""
    port = tp_runs["port"]["moe"]
    assert port["drops_step1"] > 0
    one = tp_runs["one"]["moe_12"]["steps"][0]["loss"]
    assert abs(port["steps"][0]["loss"] - one) > 1e-4 * abs(one)


def test_param_shards_and_zero1_specs_match_jax(tp_runs):
    """Each rank's param is its shard of the JAX leaf (the JAX leaf's
    shape over the spec's parts), the JAX shapes include the padding, and
    the ZeRO-1 optimizer-state specs equal the JAX package's leaf by
    leaf."""
    for name in ("llama_generic", "padded", "moe"):
        port, jx = tp_runs["port"][name], tp_runs["jax"][name]
        assert set(port["param_shapes"]) == set(jx["param_shapes"])
        for k, want in jx["param_shapes"].items():
            tp = 4 if name == "padded" else 2
            parts = [tp if e == "model" else 1
                     for e in port["param_specs"][k]]
            assert [w // n for w, n in zip(want, parts)] == \
                port["param_shapes"][k], (name, k)
    pad = tp_runs["jax"]["padded"]["param_shapes"]
    wq = next(v for k, v in pad.items() if k.endswith("['wq']"))
    assert wq[2] == 8                      # 6 q heads padded to 8
    j = tp_runs["jax"]["llama_host"]["opt_specs"]
    t = {k[len("['m']"):]: v
         for k, v in tp_runs["port"]["llama_host"]["opt_specs"].items()
         if k.startswith("['m']")}
    assert set(j) == set(t)
    assert any(_norm(v) == (None, "data", "model", None) for v in j.values())
    for k in j:
        assert _norm(t[k]) == _norm(j[k]), k


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,tokens", [
    ("llama_generic", 4 * S), ("llama_host", 4 * S), ("padded", 8 * S),
    ("moe", 4 * S), ("llama_12", 8 * S), ("llama_12_remat", 8 * S),
    ("moe_14", 8 * S)])
def test_tp_wire_bytes_equal_the_formula(tp_runs, name, tokens):
    """The bytes each step hands to the model axis equal
    ``chip_smoke.tp_wire_bytes`` of the shapes (its docstring states the
    formula: per block the entry and exit all-reduces of (B_local, S, D)
    and of the k/v heads in the compute dtype, the MoE's routing weights,
    remat's recomputed exits, the embedding's exit, the head's entry and
    the cross entropy's three float32 row reductions); the explicit wire
    is the same."""
    from repro_torch.configs import get_config
    sc = next(sc for sc in PLAN["tp"]["world4"] + PLAN["tp"]["world2"]
              if sc["name"] == name)
    line = next(ln for ln in sc["imagefile"].splitlines()
                if ln.startswith("ARCH"))
    base, *kv = line.split()[1:]
    cfg = get_config(base, **{k: json.loads(v) for k, v in
                              (x.split("=") for x in kv)})
    remat = "full" if "remat=full" in sc["imagefile"] else "none"
    want = tp_wire_bytes(cfg, cfg.n_kv_heads, tokens, 4, remat)
    assert [s["tp"] for s in tp_runs["port"][name]["steps"]] == \
        [want] * STEPS
    if remat == "full":
        _steps_close(tp_runs["port"]["llama_12"]["steps"],
                     tp_runs["port"][name]["steps"], FP32_TOL)


@pytest.mark.parametrize("abi", ["generic", "host"])
def test_abi_bytes_are_each_ranks_shards(tp_runs, abi):
    """At (2, 2) the batch axes' collectives move each rank's own
    model-axis shards: the (2, 1) run's bytes, leaf by leaf, over the
    parts the model axis splits each leaf into."""
    name = "llama_generic" if abi == "generic" else "llama_host"
    ref = "llama_21" if abi == "generic" else "llama_21_host"
    p22, p21 = tp_runs["port"][name], tp_runs["port"][ref]
    whole = {k: int(np.prod(v)) for k, v in p21["param_shapes"].items()}
    local = {k: int(np.prod(v)) for k, v in p22["param_shapes"].items()}

    def bytes_of(sizes, run):
        split = {k[len("['m']"):] for k, v in run["opt_specs"].items()
                 if k.startswith("['m']") and "data" in json.dumps(v)}
        if abi == "generic":
            return {"all_reduce": 8 * sum(sizes.values())}
        return {"all_reduce": 8 * sum(n for k, n in sizes.items()
                                      if k not in split),
                "reduce_scatter": 4 * sum(sizes[k] for k in split),
                "all_gather": 4 * sum(sizes[k] for k in split)}
    for run, sizes in ((p21, whole), (p22, local)):
        want = {op: n for op, n in bytes_of(sizes, run).items() if n}
        for step in run["steps"]:
            assert step["abi_by_op"] == want
    assert sum(local.values()) < sum(whole.values())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _host_ckpt(tp_runs) -> Path:
    return tp_runs["work"] / "ckpt-llama_host"


def test_tp_checkpoint_resumes_on_one_process(tp_runs):
    """The (2, 2) host run's step-2 checkpoint (model shards and ZeRO-1
    parts, gathered whole) restored onto the same mesh gives every rank
    its parts back exactly, and restored onto one process its step 3
    equals a straight one-process run's within FP32_TOL."""
    assert tp_runs["port"]["llama_host"]["restored_equal"] is True
    work = tp_runs["work"]
    rt = Runtime(work / "resume")
    c = rt.run(rt.build(_image(LLAMA, "host")), platform="cpu")
    t = {"params": c.abstract_params(), "opt": c.abstract_opt_state()}
    sh = {"params": c.param_shardings(), "opt": c.opt_state_shardings()}
    restored = reshard_restore(CheckpointStore(_host_ckpt(tp_runs)), t, sh,
                               step=2)
    assert int(restored["opt"]["step"]) == 2
    _, _, m = c.train_step_fn()(restored["params"], restored["opt"],
                                tp_runs["batches"][2])
    straight = tp_runs["one"]["llama_12"]["steps"][2]
    _close(straight["loss"], float(m["loss"]), FP32_TOL)
    _close(straight["grad_norm"], float(m["grad_norm"]), FP32_TOL)


def test_tp_checkpoint_loads_in_the_jax_package(tp_runs):
    """The checkpoint holds whole tensors in the single-process layout:
    the JAX package restores it into its own template, equal to the
    port's restore."""
    root = _host_ckpt(tp_runs)
    jrt = JRuntime(tp_runs["work"] / "jload")
    jc = jrt.run(jrt.build(_image(LLAMA, "host")))
    tmpl = {"params": jc.abstract_params(), "opt": jc.abstract_opt_state()}
    jtree = _flat(JStore(root).restore(tmpl, 2))
    ttree = dict(_flatten(CheckpointStore(root).restore(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tmpl), 2)))
    assert set(jtree) == set(ttree)
    for k, a in jtree.items():
        np.testing.assert_array_equal(np.asarray(a), ttree[k].numpy())


# ---------------------------------------------------------------------------
# one process: no model axis, no TP operator; what is not ported raises
# ---------------------------------------------------------------------------

def test_model_axis_of_one_runs_no_tp_operator(monkeypatch, tmp_path):
    """With ``model`` at 1 the model has no axis and never calls the
    tensor-parallel Functions or the model-axis all-reduce: a train step
    of llama and of moonshot runs with them made to raise."""
    from repro_torch.dist import sharding
    def boom(*a, **k):
        raise AssertionError("a TP operator ran at model 1")
    monkeypatch.setattr(sharding._CopyToModel, "apply", boom)
    monkeypatch.setattr(sharding._ReduceFromModel, "apply", boom)
    monkeypatch.setattr(sharding.ModelAxis, "all_reduce", boom)
    data = SyntheticLM(DataConfig(vocab_size=256, seq_len=S, global_batch=4,
                                  seed=1))
    rt = Runtime(tmp_path / "rt")
    for arch in (LLAMA, MOE):
        c = rt.run(rt.build(_image(arch)), platform="cpu")
        assert c.model.axis is None
        params = c.init_params(0)
        _, _, m = c.train_step_fn()(params, c.init_opt_state(params),
                                    data.batch(0))
        assert np.isfinite(float(m["loss"]))


def _axis(tp: int) -> ModelAxis:
    return ModelAxis(PlatformMesh(("data", "model"), (1, tp)))


def _raises_13(fn):
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        fn()


@pytest.mark.parametrize("what", ["fsdp", "ssm", "rec", "decode", "paged",
                                  "prefill_cache", "powersgd",
                                  "moe_model_1"])
def test_unported_raises_naming_item_13(what, tmp_path):
    """What this slice leaves unported raises, naming ROADMAP.md Queue 1
    item 13: FSDP, ``ssm``/``rec`` blocks on a model axis, decode and
    paged serving (and a serving prefill) on a rank's shards, PowerSGD on
    a model axis (the reference compresses whole matrices), and an MoE
    arch on several data replicas with ``model`` at 1 (which also names
    Queue 3 item 14, the global capacity)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    rt = Runtime(tmp_path / "rt")
    if what == "fsdp":
        rt.build(_image(LLAMA) + "SET fsdp=true\n", tag="f")
        _raises_13(lambda: rt.run("f", platform="cpu"))
    elif what in ("ssm", "rec"):
        arch = {"ssm": "mamba2-2.7b-smoke", "rec": "recurrentgemma-2b-smoke"}
        _raises_13(lambda: Model(get_config(arch[what]), tp=2,
                                 axis=_axis(2)))
    elif what in ("decode", "prefill_cache"):
        cfg = get_config(LLAMA)
        m = Model(cfg, tp=2, act_dtype=torch.float32, axis=_axis(2))
        tok = torch.zeros((1, 4), dtype=torch.long)
        if what == "decode":
            _raises_13(lambda: m.decode_step({}, {}, tok[:, :1], 0))
        else:
            _raises_13(lambda: m.forward({}, tok, collect_cache=True))
    elif what == "powersgd":
        rt.build(_image(LLAMA, "host mode=explicit compression=powersgd "
                               "rank=4"), tag="p")
        _raises_13(lambda: rt.run(
            "p", platform="cpu",
            mesh=PlatformMesh(("data", "model"), (1, 2))))
    elif what == "paged":
        cfg = get_config(LLAMA)
        geom = resolve_geometry(cfg, 2)
        p = {"wq": torch.zeros(cfg.d_model, geom.n_q // 2, geom.head_dim)}
        _raises_13(lambda: attn_mod.paged_decode_attn(
            p, None, None, None, None, cfg, geom))
        _raises_13(lambda: attn_mod.decode_attn(
            p, None, None, None, cfg, geom))
    else:
        rt.build(_image(MOE), tag="moe")
        with pytest.raises(NotImplementedError,
                           match="Queue 1 item 13") as err:
            rt.run("moe", platform="cpu",
                   mesh=PlatformMesh(("data", "model"), (2, 1)))
        assert "Queue 3 item 14" in str(err.value)


def test_moe_param_specs_are_the_containers_shards():
    """``moe_param_specs`` (the reference's shard_map in_specs) name the
    split of each MoE leaf that the logical rules give at ``model`` 16."""
    from repro_torch.configs import get_config
    cfg = get_config("moonshot-v1-16b-a3b")
    mesh = PlatformMesh(("data", "model"), (16, 16))
    defs = Model(cfg, tp=16).param_defs()
    moe = defs["stage1"]["b0"]["moe"]
    got = def_shardings(moe, mesh, ShardingRules.default())
    want = moe_mod.moe_param_specs(cfg)
    for (k, sh), (k2, spec) in zip(_flatten(got),
                                   sorted(_spec_paths(want).items())):
        assert k == k2 and _norm(sh.spec) == (None, *spec), k
    assert isinstance(got["router"], NamedSharding)


def _spec_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_spec_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    return {prefix: tree}
