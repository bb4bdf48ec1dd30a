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
assignments by a capacity per data shard; weight FSDP (``SET
fsdp=true``) for llama at (2, 2) and (4, 1) under the three ABIs and for
moonshot at (2, 2) with drops; mamba2-2.7b-smoke and
recurrentgemma-2b-smoke at (1, 4) and (2, 2). The 4-rank job also runs
``cli run`` of an FSDP image on its (4, 1) mesh.

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
from repro_torch.dist.sharding import (NamedSharding, ShardingRules,
                                       def_shardings)
from repro_torch.models import moe as moe_mod
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


MAMBA = "mamba2-2.7b-smoke"
RGEMMA = "recurrentgemma-2b-smoke"
FSDP = " fsdp=true"
# (weights key) -> (arch, the tp its geometry is padded for)
WEIGHTS = {"l1": (LLAMA, 1), "l2": (LLAMA, 2), "l4": (LLAMA, 4),
           "pad": (PADDED, 4), "m2": (MOE, 2), "m4": (MOE, 4),
           "s2": (MAMBA, 2), "s4": (MAMBA, 4), "r2": (RGEMMA, 2),
           "r4": (RGEMMA, 4)}
HELD = [  # held to the JAX step over the same mesh
    _sc("llama_generic", LLAMA, (2, 2), "l2", grads=True),
    _sc("llama_host", LLAMA, (2, 2), "l2", "host", ckpt=True),
    _sc("llama_explicit_f32", LLAMA, (2, 2), "l2", EXPLICIT_F32),
    _sc("llama_explicit", LLAMA, (2, 2), "l2", EXPLICIT),
    _sc("padded", PADDED, (1, 4), "pad", grads=True),
    _sc("moe", MOE, (2, 2), "m2", grads=True),
    # weight FSDP: SET fsdp=true on the same meshes
    _sc("fsdp_generic", LLAMA, (2, 2), "l2", extra=FSDP, grads=True),
    _sc("fsdp_host", LLAMA, (2, 2), "l2", "host", FSDP, ckpt=True),
    _sc("fsdp_explicit", LLAMA, (2, 2), "l2", EXPLICIT_F32, FSDP),
    _sc("fsdp_generic_41", LLAMA, (4, 1), "l1", extra=FSDP, grads=True),
    _sc("fsdp_host_41", LLAMA, (4, 1), "l1", "host", FSDP),
    _sc("fsdp_explicit_41", LLAMA, (4, 1), "l1", EXPLICIT_F32, FSDP),
    _sc("fsdp_moe", MOE, (2, 2), "m2", extra=FSDP, grads=True),
    # ssm and rec blocks on a model axis
    _sc("mamba_14", MAMBA, (1, 4), "s4", grads=True),
    _sc("mamba_22", MAMBA, (2, 2), "s2", grads=True),
    _sc("rgemma_14", RGEMMA, (1, 4), "r4", grads=True),
    _sc("rgemma_22", RGEMMA, (2, 2), "r2", grads=True),
]
CLI_STEPS = 3
PLAN = {"tp": {
    "steps": STEPS,
    "cli": CLI_STEPS,
    "jax": HELD,
    "world4": HELD + [_sc("llama_14", LLAMA, (1, 4), "l4"),
                      _sc("moe_14", MOE, (1, 4), "m4")],
    "world2": [_sc("llama_12", LLAMA, (1, 2), "l2"),
               _sc("llama_12_remat", LLAMA, (1, 2), "l2",
                   extra=" remat=full"),
               _sc("moe_12", MOE, (1, 2), "m2"),
               _sc("llama_21", LLAMA, (2, 1), "l2"),
               _sc("llama_21_host", LLAMA, (2, 1), "l2", "host"),
               _sc("mamba_12_remat", MAMBA, (1, 2), "s2",
                   extra=" remat=full"),
               _sc("rgemma_12_remat", RGEMMA, (1, 2), "r2",
                   extra=" remat=full"),
               _sc("fsdp_21_full", LLAMA, (2, 1), "l1",
                   extra=FSDP + " remat=full"),
               _sc("fsdp_21_dots", LLAMA, (2, 1), "l1", "host",
                   FSDP + " remat=dots")],
}}
ONE_PROCESS = {"llama_12": ("l2", 2), "llama_14": ("l4", 4),
               "moe_12": ("m2", 2), "moe_14": ("m4", 4),
               "rgemma_14": ("r4", 4), "rgemma_22": ("r2", 2)}
# runs whose final params are held to the port's one process at the same
# geometry rather than to the JAX step's (test_tp_training_matches_jax
# says why); their losses, grad norms and first-step gradients are held
# to the JAX step
PARAMS_TO_ONE_PROCESS = ("rgemma_14", "rgemma_22")


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
    (work / "Imagefile.fsdp").write_text(_image(LLAMA, extra=FSDP))

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
    ("moe", FP32_TOL, PARAM_TOL),
    ("fsdp_generic", FP32_TOL, PARAM_TOL),
    ("fsdp_host", FP32_TOL, PARAM_TOL),
    ("fsdp_explicit", FP32_TOL, PARAM_TOL),
    ("fsdp_generic_41", FP32_TOL, PARAM_TOL),
    ("fsdp_host_41", FP32_TOL, PARAM_TOL),
    ("fsdp_explicit_41", FP32_TOL, PARAM_TOL),
    ("fsdp_moe", FP32_TOL, PARAM_TOL),
    ("mamba_14", FP32_TOL, PARAM_TOL),
    ("mamba_22", FP32_TOL, PARAM_TOL),
    ("rgemma_14", FP32_TOL, PARAM_TOL),
    ("rgemma_22", FP32_TOL, PARAM_TOL)])
def test_tp_training_matches_jax(tp_runs, name, tol, ptol):
    """Losses and grad norms of 3 steps, and every leaf of the final
    params, against the JAX step over the same (data, model) mesh: under
    ``fsdp=true`` the JAX step's too (its explicit path gathers the params
    at its region's entry and returns them whole, which the port's
    explicit path keeps them), and for mamba2 and recurrentgemma with
    their ``rnn``/``heads`` dims on the model axis.

    recurrentgemma's final params are held to the port's one process at
    the same geometry instead: with no model axis at all the port's
    ``gate_a_b`` (zero-initialised, its gradient a near-cancelling sum
    through the RG-LRU's sqrt(1 - a^2)) ends 3 steps 3.27e-5 relative L2
    from the JAX step's (its scan sums in another order than
    ``jax.lax.associative_scan``, and Adam divides each element by its
    own RMS), over PARAM_TOL before any rank splits it; the ranks end
    within PARAM_TOL of that one process
    (test_tp_ranks_equal_one_process), and every leaf's first-step
    gradient within PARAM_TOL of JAX's (test_tp_gradients_match_jax). The
    gap is rounding: in float64 it falls to 2.2e-7
    (tests/test_torch_rgemma_f64.py)."""
    _steps_close(tp_runs["jax"][name]["steps"],
                 tp_runs["port"][name]["steps"], tol)
    want = (tp_runs["one"][name]["params"] if name in PARAMS_TO_ONE_PROCESS
            else _pick(tp_runs["jax_arrays"], name + "/"))
    _leaves_close(want, _pick(tp_runs["port_arrays"], name + "/"), ptol)


# a leaf of each run whose gradient the test must see (a replicated one
# every rank's region adds a part of, or a trap of the ssm layout)
GRAD_LEAVES = {"llama_generic": ("wk",), "padded": ("wk",),
               "moe": ("wk", "router"), "fsdp_generic": ("wk",),
               "fsdp_generic_41": ("wk",), "fsdp_moe": ("router",),
               "mamba_14": ("conv_w", "conv_b", "gate_norm", "wB"),
               "mamba_22": ("conv_w", "conv_b", "gate_norm", "wC"),
               "rgemma_14": ("conv_w", "gate_a_w", "lam", "wk"),
               "rgemma_22": ("conv_w", "gate_x_w", "wo", "wv")}


@pytest.mark.parametrize("name", sorted(GRAD_LEAVES))
def test_tp_gradients_match_jax(tp_runs, name):
    """Every leaf's gradient of the first step (the global batch's, at the
    initial weights): the replicated leaves (``wk``, ``wv``, the router,
    the norms, mamba2's ``wB``/``wC``) included, whose gradient each
    rank's region adds a part of; under FSDP each rank's part of it,
    reduce-scattered in the backward. For mamba2 this is the check of
    the layout's two traps: the conv rows (``conv_w``/``conv_b``: d_inner
    + 2 ssm_state rows split where ``xi``'s d_inner is not, the B/C rows
    on the last rank) each get their gradient exactly once, and
    ``gate_norm``'s gradient comes through ``rms_gated``'s mean over the
    whole d_inner."""
    prefix = f"{name}/grad/"
    want = {k[len(prefix):]: v for k, v in tp_runs["jax_arrays"].items()
            if k.startswith(prefix)}
    got = {k[len(prefix):]: v for k, v in tp_runs["port_arrays"].items()
           if k.startswith(prefix)}
    assert want and set(want) == set(got)
    for leaf in GRAD_LEAVES[name]:
        assert any(f"['{leaf}']" in k for k in want), leaf
    _leaves_close(want, got, PARAM_TOL)


@pytest.mark.parametrize("name", sorted(ONE_PROCESS))
def test_tp_ranks_equal_one_process(tp_runs, name):
    """(1, 2) and (1, 4) -- and recurrentgemma's (2, 2) -- equal the
    port's own one-process run at the same padded geometry (for the MoE
    one data replica's capacity per shard is the global one): losses and
    grad norms within FP32_TOL, final params within PARAM_TOL. The ranks sum each region's partial outputs and
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


@pytest.mark.parametrize("name", ["fsdp_generic", "fsdp_host",
                                  "fsdp_moe"])
def test_fsdp_param_and_opt_specs_match_jax_at_2x2(tp_runs, name):
    """Under ``fsdp=true`` each rank holds the part of every leaf that the
    JAX package's param specs give it at (2, 2) (its ``embed`` dim over
    ``data`` as well as its model-axis dim), and m and v split alike,
    leaf by leaf."""
    port, jx = tp_runs["port"][name], tp_runs["jax"][name]
    assert set(port["param_specs"]) == set(jx["param_specs"])
    for k, spec in jx["param_specs"].items():
        assert _norm(port["param_specs"][k]) == _norm(spec), k
        parts = [2 if e else 1 for e in _norm(spec)]
        assert [w // n for w, n in zip(jx["param_shapes"][k], parts)] == \
            port["param_shapes"][k], k
    assert any("data" in json.dumps(v) for v in jx["param_specs"].values())
    t = {k[len("['m']"):]: v for k, v in port["opt_specs"].items()
         if k.startswith("['m']")}
    assert set(t) == set(jx["opt_specs"])
    for k, spec in jx["opt_specs"].items():
        assert _norm(t[k]) == _norm(spec), k


@pytest.mark.parametrize("arch,abi", [(LLAMA, "generic"), (LLAMA, "host"),
                                      (MOE, "generic"), (MAMBA, "host")])
def test_fsdp_specs_match_jax_at_16x16(tmp_path, arch, abi):
    """At the ``pod`` platform's (16, 16) the port's FSDP param and
    optimizer-state specs (the container's rules over its mesh's shape)
    equal the JAX package's (its container's rules, ``safe_spec`` over a
    mesh of that shape) leaf by leaf, the full archs' shapes included."""
    from types import SimpleNamespace

    from repro.dist.sharding import safe_spec as j_safe_spec
    from repro_torch.configs import get_config
    full = arch.split()[0].removesuffix("-smoke")
    img = _image(arch, abi, FSDP)
    rt = Runtime(tmp_path / "p")
    c = rt.run(rt.build(img), platform="cpu")
    jrt = JRuntime(tmp_path / "j")
    jc = jrt.run(jrt.build(img))
    assert c.fsdp and jc.rules.rules["embed"] == ("pod", "data")
    shape = {"data": 16, "model": 16}
    jmesh = SimpleNamespace(shape=shape, axis_names=("data", "model"))
    mesh = PlatformMesh(("data", "model"), (16, 16))
    defs = Model(get_config(full), tp=16).param_defs()
    for rules, jrules in ((c.rules, jc.rules), (c.opt_rules, jc.opt_rules)):
        got = dict(_flatten(def_shardings(defs, mesh, rules)))
        split = 0
        for k, d in _flatten(defs):
            want = tuple(j_safe_spec(d.shape, d.logical, jmesh, jrules))
            assert _norm(got[k].spec) == _norm(want), k
            split += "data" in json.dumps(want)
        assert split


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------

def _scenario(name: str) -> tuple[dict, object, str]:
    """A scenario of the plan, its arch's config and its remat mode."""
    from repro_torch.configs import get_config
    sc = next(sc for sc in PLAN["tp"]["world4"] + PLAN["tp"]["world2"]
              if sc["name"] == name)
    line = next(ln for ln in sc["imagefile"].splitlines()
                if ln.startswith("ARCH"))
    base, *kv = line.split()[1:]
    cfg = get_config(base, **{k: json.loads(v) for k, v in
                              (x.split("=") for x in kv)})
    remat = next((m for m in ("full", "dots")
                  if f"remat={m}" in sc["imagefile"]), "none")
    return sc, cfg, remat


@pytest.mark.parametrize("name,tokens", [
    ("llama_generic", 4 * S), ("llama_host", 4 * S), ("padded", 8 * S),
    ("moe", 4 * S), ("llama_12", 8 * S), ("llama_12_remat", 8 * S),
    ("moe_14", 8 * S), ("mamba_14", 8 * S), ("mamba_22", 4 * S),
    ("rgemma_14", 8 * S), ("rgemma_22", 4 * S),
    ("mamba_12_remat", 8 * S), ("rgemma_12_remat", 8 * S),
    ("fsdp_generic", 4 * S), ("fsdp_moe", 4 * S)])
def test_tp_wire_bytes_equal_the_formula(tp_runs, name, tokens):
    """The bytes each step hands to the model axis equal
    ``chip_smoke.tp_wire_bytes`` of the shapes (its docstring states the
    formula: per block the entry and exit all-reduces of (B_local, S, D)
    and of the k/v heads in the compute dtype, the MoE's routing weights,
    the ssm block's B/C entries, norm sums and conv-row gathers, remat's
    recomputed exits, the embedding's exit, the head's entry and the
    cross entropy's three float32 row reductions); the explicit wire is
    the same, and FSDP adds nothing on the model axis. A remat=full run
    takes the steps of the run without it."""
    sc, cfg, remat = _scenario(name)
    want = tp_wire_bytes(cfg, cfg.n_kv_heads, tokens, 4, remat)
    assert [s["tp"] for s in tp_runs["port"][name]["steps"]] == \
        [want] * STEPS
    if remat == "full":
        plain = {"llama_12_remat": "llama_12", "mamba_12_remat": "mamba_14",
                 "rgemma_12_remat": "rgemma_14"}[name]
        _steps_close(tp_runs["port"][plain]["steps"],
                     tp_runs["port"][name]["steps"], FP32_TOL)


@pytest.mark.parametrize("name", ["fsdp_generic", "fsdp_host",
                                  "fsdp_generic_41", "fsdp_host_41",
                                  "fsdp_moe", "fsdp_21_full",
                                  "fsdp_21_dots"])
def test_fsdp_wire_bytes_equal_the_formula(tp_runs, name):
    """The bytes each FSDP step hands to the ABI equal
    ``chip_smoke.fsdp_wire_bytes`` (its docstring states the formula: the
    all-gathers at use and at remat's recompute, the reduce-scatters of
    the gradients, the all-reduces of the leaves FSDP does not split; no
    all-gather after the update), by operation; and remat=full and
    remat=dots take the steps of the run without remat."""
    from chip_smoke import fsdp_wire_bytes
    sc, cfg, remat = _scenario(name)
    want = fsdp_wire_bytes(cfg, *sc["shape"], remat)
    steps = tp_runs["port"][name]["steps"]
    assert [s["wire"] for s in steps] == [want] * STEPS
    assert set(steps[0]["abi_by_op"]) <= {"all_gather", "reduce_scatter",
                                          "all_reduce"}
    assert steps[0]["abi_by_op"]["all_gather"] > 0
    if remat != "none":
        _steps_close(tp_runs["port"]["fsdp_generic_41"]["steps"], steps,
                     FP32_TOL)


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

def _host_ckpt(tp_runs, name) -> Path:
    return tp_runs["work"] / f"ckpt-{name}"


@pytest.mark.parametrize("name,extra", [("llama_host", ""),
                                        ("fsdp_host", FSDP)])
def test_tp_checkpoint_resumes_on_one_process(tp_runs, name, extra):
    """The (2, 2) host run's step-2 checkpoint (model shards and ZeRO-1
    parts -- under FSDP the params' parts too -- gathered whole) restored
    onto the same mesh gives every rank its parts back exactly, and
    restored onto one process its step 3 equals a straight one-process
    run's within FP32_TOL."""
    assert tp_runs["port"][name]["restored_equal"] is True
    work = tp_runs["work"]
    rt = Runtime(work / f"resume-{name}")
    c = rt.run(rt.build(_image(LLAMA, "host", extra)), platform="cpu")
    t = {"params": c.abstract_params(), "opt": c.abstract_opt_state()}
    sh = {"params": c.param_shardings(), "opt": c.opt_state_shardings()}
    restored = reshard_restore(CheckpointStore(_host_ckpt(tp_runs, name)),
                               t, sh, step=2)
    assert int(restored["opt"]["step"]) == 2
    _, _, m = c.train_step_fn()(restored["params"], restored["opt"],
                                tp_runs["batches"][2])
    straight = tp_runs["one"]["llama_12"]["steps"][2]
    _close(straight["loss"], float(m["loss"]), FP32_TOL)
    _close(straight["grad_norm"], float(m["grad_norm"]), FP32_TOL)


@pytest.mark.parametrize("name,extra", [("llama_host", ""),
                                        ("fsdp_host", FSDP)])
def test_tp_checkpoint_loads_in_the_jax_package(tp_runs, name, extra):
    """The checkpoint holds whole tensors in the single-process layout:
    the JAX package restores it into its own template, equal to the
    port's restore."""
    root = _host_ckpt(tp_runs, name)
    jrt = JRuntime(tp_runs["work"] / f"jload-{name}")
    jc = jrt.run(jrt.build(_image(LLAMA, "host", extra)))
    tmpl = {"params": jc.abstract_params(), "opt": jc.abstract_opt_state()}
    jtree = _flat(JStore(root).restore(tmpl, 2))
    ttree = dict(_flatten(CheckpointStore(root).restore(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tmpl), 2)))
    assert set(jtree) == set(ttree)
    for k, a in jtree.items():
        np.testing.assert_array_equal(np.asarray(a), ttree[k].numpy())


def test_cli_run_under_fsdp_equals_one_process(tp_runs, tmp_path):
    """``cli run`` of an image with ``SET fsdp=true`` on the 4 ranks' local
    (4, 1) mesh (the ranks' process group, as torchrun's) trains: rank 0's
    losses equal one process's run of the same image, whose FSDP splits
    nothing, within FP32_TOL."""
    from repro_torch.cli import main as cli_main

    def losses(root: Path) -> list:
        recs = [json.loads(ln) for p in sorted(root.glob(
            "overlays/*/metrics.jsonl")) for ln in p.read_text().splitlines()]
        return [r["loss"] for r in sorted(recs, key=lambda r: r["step"])]
    ranks = losses(tp_runs["work"] / "cli-fsdp")
    assert cli_main(["--root", str(tmp_path / "one"), "run",
                     str(tp_runs["work"] / "Imagefile.fsdp"), "--platform",
                     "cpu", "--steps", str(CLI_STEPS)]) == 0
    one = losses(tmp_path / "one")
    assert len(ranks) == len(one) == CLI_STEPS
    for a, b in zip(one, ranks):
        _close(a, b, FP32_TOL)


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


def _raises_13(fn):
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        fn()


@pytest.mark.parametrize("what", ["powersgd", "moe_model_1"])
def test_unported_raises_naming_item_13(what, tmp_path):
    """What is left unported raises, naming ROADMAP.md Queue 1 item 13:
    PowerSGD on a model axis (the reference compresses whole matrices),
    and an MoE arch on several data replicas with ``model`` at 1 (which
    also names Queue 3 item 14, the global capacity). Serving on a rank's
    shards is tests/test_torch_tp_serve.py's."""
    rt = Runtime(tmp_path / "rt")
    if what == "powersgd":
        rt.build(_image(LLAMA, "host mode=explicit compression=powersgd "
                               "rank=4"), tag="p")
        _raises_13(lambda: rt.run(
            "p", platform="cpu",
            mesh=PlatformMesh(("data", "model"), (1, 2))))
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
