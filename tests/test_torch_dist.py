"""The port's multi-process training against the JAX package, on the CPU.

The port's ranks are gloo processes (``tests/torch_dist_worker.py``, one
process a rank, ``jax`` and ``repro`` unimportable in them); the JAX side
is ``tests/torch_dist_jax.py`` in a subprocess whose XLA sees 4 host
devices. Both start from the JAX package's seed-0 weights (as numpy) and
take the same global batches, so the port's 4 ranks are held to the JAX
step over a mesh of the same shape. One module fixture spawns each world
once and runs every scenario inside it (about a minute in all).

Tolerances:

* float32 wires, 3 steps: loss and ``grad_norm`` within FP32_TOL = 1e-5
  relative of JAX's (the runs show 5.7e-7 at most); final params, as the
  relative L2 error of each leaf, within PARAM_TOL = 3e-5 of JAX's (the
  runs show 8.0e-6: Adam divides each gradient element by its own RMS,
  so two libraries' rounding moves the elements whose gradient is near
  zero by a share of the learning rate; one process of the port sits
  7.7e-6 from JAX as well), and within FP32_TOL of the port's own
  one-process run (3.9e-7: distributing adds nothing);
* the bfloat16 wire (``host mode=explicit``): BF16_TOL = 2e-3 relative on
  loss and grad_norm (the runs show 3.4e-4) and BF16_PARAM_TOL = 1e-2 on
  params (2.9e-3): gloo sums four bfloat16 gradients with a rounding at
  each addition where XLA's CPU all-reduce rounds otherwise; beside
  tests/test_train.py::test_abi_bf16_compression_close_to_fp32's 5e-2;
* sharding specs: equal, leaf by leaf; wire bytes: the bounds of
  tests/test_compression.py::test_powersgd_cuts_wire_bytes_multidevice;
* checkpoints moved between world sizes: each resumed step within
  FP32_TOL of a straight run's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh

from repro.checkpoint.store import CheckpointStore as JStore
from repro.configs import get_config as j_get_config
from repro.core.runtime import Runtime as JRuntime
from repro.dist.sharding import ShardingRules as JRules
from repro.dist.sharding import safe_spec as j_safe_spec
from repro.models.params import shardings as j_def_shardings
from repro.models.transformer import Model as JModel
from repro.train.compression import powersgd_init as j_powersgd_init
from repro_torch.checkpoint.store import (CheckpointStore, _flatten,
                                          _unflatten)
from repro_torch.data.pipeline import DataConfig, SyntheticLM, rank_rows
from repro_torch.dist.mesh import PLATFORMS, PlatformMesh, batch_axes
from repro_torch.dist.sharding import (NamedSharding, ShardingRules,
                                       check_divisibility, def_shardings,
                                       safe_spec)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import backend_for
from repro_torch.launch.train import main as train_main
from repro_torch.models.params import ParamDef

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
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


def _image(collectives, arch="llama3.2-3b-smoke", extra=""):
    return IMAGEFILE.format(arch=arch, collectives=collectives, extra=extra)


PLAN = {
    "steps": STEPS,
    "abis": {
        "generic": _image("generic"),
        "host": _image("host"),
        "explicit_f32": _image("host mode=explicit grad_compression=float32"),
        "explicit_bf16": _image("host mode=explicit"),
        "powersgd": _image("host mode=explicit grad_compression=float32 "
                           "compression=powersgd rank=4"),
    },
    "hier": {
        "hier_f32": {"grad_compression": "float32", "hierarchical": True},
        "flat_f32": {"grad_compression": "float32", "hierarchical": False},
        "hier_bf16": {"grad_compression": "bfloat16", "hierarchical": True},
    },
    "masked": {
        "generic_mb1": _image("generic"),
        "host_mb2": _image("host", extra=" microbatches=2"),
    },
    # the MoE's dispatch over the global batch of 4 data replicas, with
    # capacity low enough to drop
    "moe": _image("generic",
                  arch="moonshot-v1-16b-a3b-smoke capacity_factor=0.5"),
}
# mask counts of the 8 rows: rank r holds rows 2r, 2r+1 (rank 1 none); in
# two microbatches rows r and 4 + r (ranks 2 and 3 none in the first)
MASK_COUNTS = (16, 3, 0, 0, 9, 16, 1, 5)


def _save(path, **arrays):
    np.savez(path, **arrays)


def _paths(tree, is_leaf=None) -> dict:
    """keystr path -> leaf (the port's checkpoint paths)."""
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in _paths(tree).items()}


def _poison(root: Path) -> Path:
    """A directory whose ``jax`` and ``repro`` raise on import."""
    for name in ("jax", "repro"):
        (root / name).mkdir(parents=True)
        (root / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable here')\n")
    return root


def _spawn(job: str, world: int, work: Path, env: dict) -> list:
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"), job,
         str(r), str(world), str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs: list, what: str, timeout: float = 400) -> None:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(p.returncode, o[-3000:]) for p, o in zip(procs, outs)
           if p.returncode]
    assert not bad, f"{what}: {bad}"


def _one_process(work: Path) -> dict:
    """The generic ABI's 3 steps in this process (no process group)."""
    from repro_torch.core.runtime import Runtime
    rt = Runtime(work / "one")
    c = rt.run(rt.build(PLAN["abis"]["generic"]), platform="cpu")
    with np.load(work / "params.npz") as z:
        params = c.load_params(_unflatten(c.param_defs, dict(z)))
    opt, step, rec = c.init_opt_state(params), c.train_step_fn(), []
    for i in range(STEPS):
        with np.load(work / f"batch{i}.npz") as z:
            params, opt, m = step(params, opt, dict(z))
        rec.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
    return {"steps": rec, "params": {k: v.numpy()
                                     for k, v in _flatten(params)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    (work / "plan.json").write_text(json.dumps(PLAN))
    (work / "Imagefile.zero1").write_text(_image("host"))
    jrt = JRuntime(work / "jinit")
    jc = jrt.run(jrt.build(PLAN["abis"]["generic"]))
    jparams = jc.init_params(0)
    _save(work / "params.npz", **_flat(jparams))
    q = j_powersgd_init(jparams, 4)["q"]
    _save(work / "jax_q.npz", **_flat(q))
    jc = jrt.run(jrt.build(PLAN["moe"]))
    _save(work / "params-moe.npz", **_flat(jc.init_params(0)))
    cfg = jc.arch
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=5))
    rng = np.random.default_rng(7)
    for i in range(STEPS):
        _save(work / f"batch{i}.npz", **data.batch(i))
        mask = np.zeros((B, S), np.float32)
        for row, n in enumerate(MASK_COUNTS):
            mask[row, rng.permutation(S)[:n]] = 1.0
        _save(work / f"mask{i}.npz", loss_mask=mask)
    _save(work / "g512.npz", w=rng.standard_normal((512, 512)).astype(
        np.float32))

    src = str(ROOT / "src")
    port_env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(_poison(work / "poison")), src]), "OMP_NUM_THREADS": "1"}
    # XLA's CPU compiler aborts on a bfloat16 all-reduce over host devices
    # in its all-reduce-promotion pass ("Invalid binary instruction opcode
    # copy", jax 0.9); without that pass the bf16 wire runs in bfloat16
    jax_env = {**os.environ, "PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                            "--xla_disable_hlo_passes=all-reduce-promotion"}
    jproc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_jax.py"),
         str(work)], env=jax_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait(_spawn("world4", 4, work, port_env), "4 ranks")
        _wait(_spawn("world2", 2, work, port_env), "2 ranks")
    finally:
        _wait([jproc], "the JAX side")
    one_process = _one_process(work)
    one = train_main(["--image", str(work / "Imagefile.zero1"), "--platform",
                      "cpu", "--root", str(work / "chain"), "--resume",
                      "--steps", "1"])
    with np.load(work / "world4.npz") as z:
        port_arrays = {k: z[k] for k in z.files}
    with np.load(work / "jax.npz") as z:
        jax_arrays = {k: z[k] for k in z.files}
    return {"work": work, "port": json.loads((work / "world4.json")
                                             .read_text()),
            "world2": json.loads((work / "world2.json").read_text()),
            "one": one, "one_process": one_process,
            "jax": json.loads((work / "jax.json").read_text()),
            "port_arrays": port_arrays, "jax_arrays": jax_arrays}


def _close(j, t, tol):
    assert abs(t - j) <= tol * max(abs(j), 1e-12), (j, t, tol)


def _steps_close(jrec, trec, tol):
    assert len(jrec) == len(trec) == STEPS
    for j, t in zip(jrec, trec):
        _close(j["loss"], t["loss"], tol)
        _close(j["grad_norm"], t["grad_norm"], tol)


def _leaves_close(want: dict, got: dict, tol: float) -> None:
    """Each leaf's relative L2 error within ``tol``."""
    assert want and set(want) == set(got)
    for k, a in want.items():
        err = float(np.linalg.norm(a - got[k]) / max(np.linalg.norm(a),
                                                     1e-30))
        assert err <= tol, (k, err, tol)


def _params_close(runs, prefix, tol):
    pick = lambda arrays: {k: v for k, v in arrays.items()  # noqa: E731
                           if k.startswith(prefix + "/")}
    _leaves_close(pick(runs["jax_arrays"]), pick(runs["port_arrays"]), tol)


# ---------------------------------------------------------------------------
# (a) sharding rules, leaf by leaf against the JAX package
# ---------------------------------------------------------------------------

MESHES = [((4, 1), ("data", "model")), ((2, 2, 1), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _norm(spec) -> tuple:
    """A spec's entries with one-axis tuples as the axis name (JAX's
    ``PartitionSpec`` holds ``("data",)`` and ``"data"`` as equal)."""
    def entry(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(entry(e) for e in spec)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-67b"])
@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
def test_sharding_specs_match_jax(arch, shape, axes, zero1, fsdp):
    """``mesh_axes`` and ``safe_spec`` of every param def, and the
    optimizer-state specs the Container derives (ZeRO-1 adds
    ``embed=("pod","data")``), equal the JAX package's on an
    ``AbstractMesh`` of the same shape."""
    jmesh = AbstractMesh(shape, axes)
    tmesh = PlatformMesh(axes, shape)
    tp = dict(zip(axes, shape))["model"]
    defs = JModel(j_get_config(arch), tp=tp).param_defs()
    jr, tr = JRules.default(fsdp=fsdp), ShardingRules.default(fsdp=fsdp)
    if zero1:
        jr, tr = jr.with_(embed=("pod", "data")), tr.with_(
            embed=("pod", "data"))
    jsh = _paths(j_def_shardings(defs, jmesh, jr))
    leaves = _paths(defs, is_leaf=lambda x: hasattr(x, "logical"))
    assert len(leaves) == len(jsh) > 0
    for key, d in leaves.items():
        want = _norm(jsh[key].spec)
        assert _norm(tr.mesh_axes(d.logical, tmesh)) == want, key
        safe = _norm(j_safe_spec(d.shape, d.logical, jmesh, jr))
        assert _norm(safe_spec(d.shape, d.logical, tmesh, tr)) == safe, key
        # these defs divide: the Container's safe specs are JAX's shardings
        assert safe == want, key
        check_divisibility(d.shape, safe, tmesh)


@given(dim0=st.integers(1, 300), dim1=st.integers(1, 300),
       mesh=st.sampled_from(MESHES))
@settings(max_examples=100, deadline=None)
def test_property_safe_spec_divisibility(dim0, dim1, mesh):
    """tests/test_sharding.py's property on the port's meshes: a safe spec
    never shards a dim unevenly, and equals the JAX package's."""
    shape, axes = mesh
    tmesh = PlatformMesh(axes, shape)
    for logical in (("batch", "mlp"), ("embed", "heads")):
        rules = ShardingRules.default(fsdp=True)
        spec = safe_spec((dim0, dim1), logical, tmesh, rules)
        check_divisibility((dim0, dim1), spec, tmesh)
        assert _norm(spec) == _norm(j_safe_spec(
            (dim0, dim1), logical, AbstractMesh(shape, axes),
            JRules.default(fsdp=True)))


def test_meshes_and_backend_are_functions_of_the_topology():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    for name in ("pod", "multipod"):
        assert PLATFORMS[name]["shape"] == {"pod": (16, 16),
                                            "multipod": (2, 16, 16)}[name]
    m = PlatformMesh(("pod", "data", "model"), (2, 2, 1), rank=3)
    assert batch_axes(m) == ("pod", "data")
    assert m.coords() == {"pod": 1, "data": 1, "model": 0}
    assert [m.coords(r)["pod"] for r in range(4)] == [0, 0, 1, 1]
    import torch
    assert backend_for(torch.device("cpu"), 1) == "gloo"


def test_zero1_parts_and_batch_rows():
    """A rank's ZeRO-1 part is its block of the split dim (row-major over
    the kept axes; ranks that share a part hold the same block), and its
    batch rows are its block of the global batch."""
    import torch
    full = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    for rank in range(4):
        mesh = PlatformMesh(("data", "model"), (4, 1), rank=rank)
        sh = NamedSharding(mesh, (None, ("data",), "model"))
        assert torch.equal(sh.local(full), full[:, 2 * rank:2 * rank + 2])
        assert sh.local_shape(full.shape) == (2, 2, 3)
        # pod alone divides 6: ranks (pod p, data d) hold block p
        mesh = PlatformMesh(("pod", "data", "model"), (2, 2, 1), rank=rank)
        sh = NamedSharding(mesh, safe_spec((6,), ("embed",), mesh,
                                           ShardingRules.default(fsdp=True)))
        assert sh.spec == (("pod",),)
        assert sh.split() == ((0, 2, [0, 0, 1, 1]),)
        batch = {"tokens": np.arange(8)[:, None]}
        assert rank_rows(batch, rank, 4)["tokens"].ravel().tolist() == [
            2 * rank, 2 * rank + 1]
    with pytest.raises(ValueError, match="does not split"):
        rank_rows({"tokens": np.zeros((6, 2))}, 0, 4)
    defs = {"w": ParamDef((4, 8), ("embed", "mlp"))}
    specs = def_shardings(defs, PlatformMesh(("data", "model"), (4, 1)),
                          ShardingRules.default().with_(embed=("pod",
                                                               "data")))
    assert specs["w"].spec == (("data",), "model")


# ---------------------------------------------------------------------------
# (b) training parity: every ABI on 4 ranks against JAX on 4 devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("abi,tol,ptol", [
    ("generic", FP32_TOL, PARAM_TOL), ("host", FP32_TOL, PARAM_TOL),
    ("explicit_f32", FP32_TOL, PARAM_TOL),
    ("explicit_bf16", BF16_TOL, BF16_PARAM_TOL),
    ("powersgd", FP32_TOL, PARAM_TOL)])
def test_training_matches_jax_on_four_ranks(runs, abi, tol, ptol):
    j, t = runs["jax"]["abis"][abi], runs["port"]["abis"][abi]
    assert j["mesh"] == {"data": 4, "model": 1}
    _steps_close(j["steps"], t["steps"], tol)
    _params_close(runs, abi, ptol)


def test_four_ranks_equal_one_process(runs):
    """The generic ABI on 4 ranks against the port's own one-process run
    on the same global batches."""
    one = runs["one_process"]
    _steps_close(one["steps"], runs["port"]["abis"]["generic"]["steps"],
                 FP32_TOL)
    _leaves_close(one["params"], {
        k[len("generic/"):]: v for k, v in runs["port_arrays"].items()
        if k.startswith("generic/")}, FP32_TOL)


def test_zero1_state_is_sharded_as_jax_shards_it(runs):
    """The host ABI's optimizer-state specs equal the JAX Container's
    leaf by leaf, and each rank holds a quarter of every m leaf (every
    smoke leaf's embed dim divides by 4)."""
    j = runs["jax"]["abis"]["host"]["opt_specs"]
    t = runs["port"]["abis"]["host"]["opt_specs"]
    assert set(j) == set(t)
    for k in j:
        assert _norm(t[k]) == _norm(j[k]), k
    generic = runs["port"]["abis"]["generic"]["m_local"]
    for k, shape in runs["port"]["abis"]["host"]["m_local"].items():
        assert np.prod(shape) * 4 == np.prod(generic[k]), k


# ---------------------------------------------------------------------------
# (c) hierarchical means on a (pod 2, data 2, model 1) mesh
# ---------------------------------------------------------------------------

def test_hierarchical_means_match_flat_and_jax(runs):
    port, jx = runs["port"]["hier"], runs["jax"]["hier"]
    _steps_close(port["flat_f32"]["steps"], port["hier_f32"]["steps"],
                 FP32_TOL)
    for name, tol, ptol in (("hier_f32", FP32_TOL, PARAM_TOL),
                            ("flat_f32", FP32_TOL, PARAM_TOL),
                            ("hier_bf16", BF16_TOL, BF16_PARAM_TOL)):
        _steps_close(jx[name]["steps"], port[name]["steps"], tol)
        _params_close(runs, f"hier_{name}", ptol)
    # two means (over pod, then data) against one over both
    flat = port["flat_f32"]["by_op"]["host"]["all_reduce"]
    assert port["hier_f32"]["by_op"]["host"]["all_reduce"] == 2 * flat


def test_zero1_parts_shared_by_ranks(runs):
    """On the (pod 2, data 2) mesh a dim of 6 splits over pod only: rank 0
    (pod 0) gets rows 0-2 of the mean over the 4 ranks (x times the mean
    of 1..4), and the all-gather gives the whole mean back."""
    got = runs["port"]["shared_parts"]
    mean = np.arange(24.0).reshape(6, 4) * 2.5
    assert got["spec"] == [["pod"], None]
    np.testing.assert_allclose(got["part"], mean[:3], rtol=1e-6)
    np.testing.assert_allclose(got["full"], mean, rtol=1e-6)


# ---------------------------------------------------------------------------
# (d) a loss mask whose counts differ between ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["generic_mb1", "host_mb2"])
def test_masked_loss_is_the_global_masked_mean(runs, name):
    """The implicit path's loss and grads are JAX's global masked mean
    (per global microbatch with ``microbatches=2``, of which each rank
    holds its block), though a rank holds no masked token: rank 1 in one
    microbatch, ranks 2 and 3 in the first of two."""
    _steps_close(runs["jax"]["masked"][name]["steps"],
                 runs["port"]["masked"][name]["steps"], FP32_TOL)
    _params_close(runs, f"masked_{name}", PARAM_TOL)


# ---------------------------------------------------------------------------
# (e) wire bytes from the port's counter
# ---------------------------------------------------------------------------

def test_wire_bytes_by_abi(runs):
    abis = runs["port"]["abis"]
    generic = abis["generic"]["by_op"]["generic"]
    host = abis["host"]["by_op"]["host"]
    bf16 = abis["explicit_bf16"]["by_op"]["host"]
    # ZeRO-1's gradient reduce-scatter and the bf16 wire's all-reduce each
    # move half the generic float32 all-reduce; ZeRO-1 adds the params'
    # all-gather
    assert host["reduce_scatter"] <= generic["all_reduce"] / 2
    assert host["reduce_scatter"] + host["all_gather"] == \
        generic["all_reduce"]
    assert sum(bf16.values()) <= sum(generic.values()) / 2
    w = runs["port"]["wire512"]
    assert w["plain"] == 2 * 512 * 512 * 4
    assert w["powersgd"] < w["plain"] / 30
    for rec in abis["generic"]["steps"]:
        assert rec["wire"] == generic["all_reduce"] // STEPS


# ---------------------------------------------------------------------------
# (f) ZeRO-1 checkpoints moved from 4 ranks to 2 and to 1
# ---------------------------------------------------------------------------

def test_zero1_checkpoint_resumes_on_fewer_ranks(runs):
    port = runs["port"]
    straight = {int(k): v for k, v in port["straight"].items()}
    first = {int(k): v for k, v in port["first"].items()}
    for s in (1, 2):
        assert first[s] == straight[s]
    two = runs["world2"]
    assert two["start_step"] == 2
    _close(straight[3], two["losses"]["3"], FP32_TOL)
    assert runs["one"]["start_step"] == 3
    _close(straight[4], runs["one"]["losses"][4], FP32_TOL)


def test_checkpoint_of_four_ranks_loads_in_the_jax_package(runs):
    """The 4-rank checkpoint holds whole tensors in the single-process
    layout: the JAX package's store restores it into its own template,
    and it equals the port's restore."""
    work = runs["work"]
    ckpt = next((work / "chain" / "overlays").glob("*/ckpt/manifests"))
    root = ckpt.parent
    jrt = JRuntime(work / "jload")
    jc = jrt.run(jrt.build(_image("host")))
    tmpl = {"params": jc.abstract_params(), "opt": jc.abstract_opt_state()}
    jtree = _flat(JStore(root).restore(tmpl, 2))
    ttree = dict(_flatten(CheckpointStore(root).restore(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tmpl), 2)))
    assert set(jtree) == set(ttree)
    for k, a in jtree.items():
        assert a.shape == tuple(ttree[k].shape), k
        np.testing.assert_array_equal(np.asarray(a), ttree[k].numpy())
    assert int(jtree["['opt']['step']"]) == 2


# ---------------------------------------------------------------------------
# (g) an MoE arch on several data replicas
# ---------------------------------------------------------------------------

def test_moe_on_four_replicas_matches_jax(runs):
    """moonshot-v1-16b-a3b-smoke at capacity factor 0.5 on the 4 ranks'
    (4, 1) mesh, generic: the reference drops by a capacity over the
    global batch there (its ``moe_forward`` under GSPMD), and so does the
    port's dispatch over the replicas. Losses and grad norms within
    FP32_TOL of the JAX step on 4 devices, final params within PARAM_TOL,
    and the assignments the first step drops, summed over the replicas,
    equal to the JAX step's (and above 0). A step's bytes: the generic
    all-reduce of every gradient (``generic_wire_bytes``) and each MoE
    layer's gather of the replicas' counts (``moe_count_bytes``)."""
    from chip_smoke import generic_wire_bytes, moe_count_bytes
    from repro_torch.configs import get_config
    port, jx = runs["port"]["moe"], runs["jax"]["moe"]
    _steps_close(jx["steps"], port["steps"], FP32_TOL)
    _params_close(runs, "moe", PARAM_TOL)
    assert port["drops_step1"] == jx["drops_step1"] > 0
    cfg = get_config("moonshot-v1-16b-a3b-smoke", capacity_factor=0.5)
    assert [s["generic"] for s in port["steps"]] == \
        [generic_wire_bytes(cfg)] * len(port["steps"])
    assert [s["moe"] for s in port["steps"]] == \
        [moe_count_bytes(cfg, 4)] * len(port["steps"])


def test_tensor_parallel_specs_raise():
    """At ``model`` 16 a spec splits several dims: each rank's part is its
    block along each (row-major over the dim's axes), ``local`` and
    ``local_shape`` agree, a dim the axes do not divide raises, and
    ``constrain`` is the identity (the model code places the
    collectives)."""
    import torch
    from repro_torch.dist.sharding import constrain
    full = torch.arange(32 * 48 * 2).reshape(32, 48, 2)
    for rank in (0, 17, 255):
        mesh = PlatformMesh(("data", "model"), (16, 16), rank=rank)
        sh = NamedSharding(mesh, (("data",), "model", None))
        (d0, p0, o0), (d1, p1, o1) = sh.split()
        assert (d0, p0, d1, p1) == (0, 16, 1, 16)
        assert o0 == [r // 16 for r in range(256)]
        assert o1 == [r % 16 for r in range(256)]
        assert [d for d, _, _ in sh.split(("data",))] == [0]
        d, m = divmod(rank, 16)
        assert torch.equal(sh.local(full), full[2 * d:2 * d + 2,
                                                3 * m:3 * m + 3])
        assert torch.equal(sh.local(full, ("data",)), full[2 * d:2 * d + 2])
        assert sh.local_shape(full.shape) == (2, 3, 2)
        with pytest.raises(ValueError, match="does not split into 16"):
            sh.local_shape((32, 40, 2))
        assert sh.split(("pod",)) == ()
        x = torch.zeros(2)
        assert constrain(x, ("batch",), mesh, ShardingRules.default()) is x
    x = torch.zeros(2)
    assert constrain(x, ("batch",), PlatformMesh(("data", "model"), (4, 1)),
                     ShardingRules.default()) is x
