"""The port's dry run (``repro_torch.launch.dryrun``, ``opdump``,
``report``) and the Container's lowering entry points, on the CPU, with
no rank spawned: a job of fake ranks (``dist.mesh.fake_job``) in this
process, tensors on ``meta``.

* (5) a meta trace (``Container.lower_step``) equals the same step run on
  the CPU under the counter, down the same kernel route: FLOPs, bytes, kernel
  calls and wire bytes by label and operation, exactly;
* (6) the whole trace at two depths differs by exactly the depth
  difference times ``lower_unit_probe``'s FLOPs and kernel calls (and its
  bytes where the step does nothing a layer outside its units);
* (7) at full width on 2 fake ranks at 2 layers, the bytes a step a rank
  are exactly those the dist phase's ranks counted on the H100 (PERF.md
  section 6: their 3-step totals over 3), and the kernel calls a step
  those ranks' launches a step;
* (8) a rank's argument bytes (params and optimizer state) on the pod and
  multipod meshes equal the JAX package's shard shapes, leaf by leaf, and
  Fig. 3's two arms order their wire and cross-pod bytes as the JAX
  package's dry run orders them (one JAX subprocess,
  tests/torch_dryrun_jax.py);
* (9) serve cells trace on the pod and multipod meshes, unit probes
  included, a rank holding 1/16 of the KV cache's ``kv_heads``, and on
  ``local``;
* (10) ``python -m repro_torch.launch.dryrun`` where ``import jax`` and
  ``import repro`` raise: an artifact, a cached rerun, the report beside a
  record in the reference's format, and ``opdump`` of the same cell.
"""

import json
import math
import os
import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.container import Container
from repro_torch.core.image import ImageBuilder
from repro_torch.core.imagefile import parse_imagefile
from repro_torch.core.trace import trace
from repro_torch.dist.mesh import fake_job, make_mesh
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import fake_platform_mesh
from repro_torch.models import attention
from repro_torch.models.config import SHAPE_CELLS
from repro_torch.models.params import tree_leaves, tree_map

REPO = Path(__file__).resolve().parents[1]


def _image(arch, shape, *, collectives="generic", settings=None,
           seq_len=16, batch=4, **arch_overrides):
    return (ImageBuilder.from_scratch().arch(arch, **arch_overrides)
            .shape(shape, seq_len=seq_len, global_batch=batch)
            .mesh("local").precision(params="float32", compute="float32")
            .collectives(collectives).set(**(settings or {"remat": "dots"}))
            .build())


def _counts(low) -> dict:
    c = low.counter
    return {"flops": c.flops, "bytes": c.bytes,
            "kernel_calls": c.kernel_calls,
            "wire": low.collectives.bytes}


# -- (5) a meta trace against the same step on the CPU --------------------------

def _cpu_args(c: Container, kind: str):
    """The step and its inputs on the CPU, at lower_step's shapes: this
    rank's params from seed 0, its optimizer state, and token ids (and
    a zero cache) from a numpy seed."""
    rng = np.random.default_rng(0)
    specs = c.input_specs(kind)
    params = c.init_params(0)

    def ids(t, rows=None):
        shape = (rows or t.shape[0], *t.shape[1:])
        return torch.from_numpy(rng.integers(0, c.arch.vocab_size, shape))

    if kind == "train":
        reps = c.mesh.axes_size([a for a in ("pod", "data")
                                 if a in c.mesh.axis_names])
        batch = {k: ids(v, v.shape[0] * reps)
                 for k, v in specs["batch"].items()}
        return c.train_step_fn(donate=True), (
            params, c.init_opt_state(params), batch)
    if kind == "prefill":
        return c.prefill_fn(), (params, ids(specs["tokens"]))
    cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                     specs["cache"])
    return c.decode_fn(), (params, cache, ids(specs["tokens"]),
                           torch.tensor(5, dtype=torch.int32))


CASES = [("llama3.2-3b-smoke", "train", (2, 1)),
         ("llama3.2-3b-smoke", "prefill", (1, 1)),
         ("llama3.2-3b-smoke", "decode", (1, 1)),
         ("mamba2-2.7b-smoke", "train", (1, 2)),
         ("recurrentgemma-2b-smoke", "train", (1, 2)),
         ("moonshot-v1-16b-a3b-smoke", "train", (1, 2))]


@pytest.mark.parametrize("arch,kind,mesh_shape", CASES,
                         ids=[f"{a}-{k}" for a, k, _ in CASES])
def test_meta_trace_equals_cpu_run(arch, kind, mesh_shape, monkeypatch):
    """On a (data, model) mesh of fake ranks (train) or one rank: FLOPs,
    bytes, kernel calls and the collectives' bytes by label and operation
    of the meta trace equal the counter's around the CPU step, exactly.
    The trace stands for the card, so attention takes the flash kernel's
    route; the CPU run is made to take it too (``on_card_route``), where
    the wrapper counts its ``cost()`` around its plain version."""
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    img = _image(arch, shape, batch=2 * mesh_shape[0])
    with fake_job(math.prod(mesh_shape)) if math.prod(mesh_shape) > 1 \
            else nullcontext():
        mesh = make_mesh(mesh_shape, ("data", "model"))
        meta = Container(img, platform="local", mesh=mesh, device="meta")
        low = meta.lower_step(kind)
        cpu = Container(img, platform="cpu", mesh=mesh)
        fn, args = _cpu_args(cpu, kind)
        monkeypatch.setattr(attention, "on_card_route", lambda t: True)
        run = trace(fn, args, mesh)[0]
    assert _counts(low) == _counts(run)
    assert low.counter.flops > 0 and low.counter.bytes > 0
    if kind == "train" and mesh_shape != (1, 1):
        assert low.collectives.wire_bytes() > 0
    if arch.startswith(("mamba2", "recurrentgemma")) or kind != "decode":
        assert low.counter.kernel_calls


# -- (6) two depths against the unit probe ----------------------------------------

SMOKE_LLAMA = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                   d_ff=128, vocab_size=256)


@pytest.mark.parametrize("kind,remat", [("train", "dots"),
                                        ("train", "full"),
                                        ("prefill", "none"),
                                        ("decode", "none")])
def test_depth_difference_is_the_unit_probe(kind, remat):
    """llama3.2-3b at the smoke widths, 2 and 5 layers: the traces differ
    by exactly 3 x the unit probe's FLOPs and kernel calls. Decode does
    nothing a layer outside its unit, so its bytes differ by 3 probes
    exactly too; a prefill also stacks each layer's cache entries (read
    and written once); a train step's optimizer and gradient stacking run
    over the stacked leaves, outside any unit (bytes not compared)."""
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    traces = {}
    for n in (2, 5):
        c = Container(_image("llama3.2-3b", shape, n_layers=n, batch=2,
                             settings={"remat": remat}, **SMOKE_LLAMA),
                      platform="local", device="meta")
        traces[n] = c.lower_step(kind).counter
        if n == 2:
            probe, count = c.lower_unit_probe(0, kind)
            assert count == 2
    p = probe.counter
    assert traces[5].flops - traces[2].flops == 3 * p.flops > 0
    calls = {k: traces[5].kernel_calls.get(k, 0) - v
             for k, v in traces[2].kernel_calls.items()}
    assert calls == {k: 3 * v for k, v in p.kernel_calls.items()}
    if kind == "train":
        # the forward, its recompute and the backward kernels
        assert p.kernel_calls == {"flash_attention_fwd": 2,
                                  "flash_attention_bwd": 1}
    diff = traces[5].bytes - traces[2].bytes
    if kind == "decode":
        assert diff == 3 * p.bytes
    if kind == "prefill":
        entry = 2 * 16 * 2 * 16 * 4          # (B, S, n_kv, hd) float32
        assert diff == 3 * (p.bytes + 2 * 2 * entry)


# -- (7) full width on two fake ranks: the card run's bytes -------------------------

DIST_IMAGEFILE = """\
FROM scratch
ARCH {arch} n_layers={layers}
SHAPE train_4k seq_len=2048 global_batch=2
MESH local
PRECISION params=float32 compute=bfloat16
COLLECTIVES {collectives}
SET remat=full optimizer={{"lr":0.0003,"warmup_steps":2,"total_steps":1000}}
"""
# (label, mesh, arch, layers, collectives, extra SET, bytes a step a rank
# by operation, kernel calls a step): the counts of chip_smoke.py's dist
# phase on the H100 (PERF.md section 6); a step runs each attention
# layer's forward twice (remat) and its backward kernels once, each rec
# layer's scan twice and its reverse scan once, each ssm layer's scan
# twice and its backward kernels once
K2_TWO_LAYERS = {"flash_attention_fwd": 4, "flash_attention_bwd": 2}
DIST_RUNS = [
    ("b generic", (2, 1), "llama3.2-3b", 2, "generic", "",
     {"generic": {"all_reduce": 4_762_755_072}}, K2_TWO_LAYERS),
    ("b host", (2, 1), "llama3.2-3b", 2, "host", "",
     {"host": {"reduce_scatter": 2_381_377_536,
               "all_gather": 2_381_377_536}}, K2_TWO_LAYERS),
    ("b explicit", (2, 1), "llama3.2-3b", 2, "host mode=explicit", "",
     {"host": {"all_reduce": 2_381_377_536}}, K2_TWO_LAYERS),
    ("d llama", (1, 2), "llama3.2-3b", 2, "generic", "",
     {"tp": 671_186_944}, K2_TWO_LAYERS),
    ("d moonshot", (1, 2), "moonshot-v1-16b-a3b", 2, "generic", "",
     {"tp": 537_165_824}, K2_TWO_LAYERS),
    ("d mamba2", (1, 2), "mamba2-2.7b", 2, "generic", "",
     {"tp": 269_375_488}, {"ssd": 4, "ssd_bwd": 2}),
    ("d recurrentgemma", (1, 2), "recurrentgemma-2b", 3, "generic", "",
     {"tp": 805_404_672}, {"rglru_scan": 4, "rglru_scan_bwd": 2,
                           "flash_attention_fwd": 2,
                           "flash_attention_bwd": 1}),
    ("e generic", (2, 1), "llama3.2-3b", 2, "generic",
     "SET fsdp=true remat=full\n", {"generic": 5_568_110_592},
     K2_TWO_LAYERS),
    ("e host", (2, 1), "llama3.2-3b", 2, "host",
     "SET fsdp=true remat=dots\n", {"host": 5_568_110_592},
     K2_TWO_LAYERS),
]


def test_full_width_fake_ranks_count_the_card_runs_bytes():
    """chip_smoke.py's dist (b), (d) and (e) jobs, traced on rank 0 of 2
    fake ranks at full width: the ABI's (or the model axis's) bytes a
    step equal what the two gloo ranks counted on the H100, exactly, by
    operation where the record gives it."""
    for label, shape, arch, layers, coll, extra, want, calls in DIST_RUNS:
        text = DIST_IMAGEFILE.format(arch=arch, layers=layers,
                                     collectives=coll) + extra
        with fake_job(2):
            mesh = make_mesh(shape, ("data", "model"))
            c = Container(parse_imagefile(text), platform="local",
                          mesh=mesh, device="meta")
            low = c.lower_step("train")
        got = low.collectives.bytes
        for key, w in want.items():
            have = got[key] if isinstance(w, dict) else sum(
                got[key].values())
            assert have == w, (label, key, got)
        assert low.counter.kernel_calls == calls, label


# -- (8) against the JAX package: argument bytes and the Fig. 3 arms ------------

ARG_CELLS = [(arch, mesh, abi)
             for arch in ("deepseek-67b", "llama4-scout-17b-a16e")
             for mesh in ("pod", "multipod") for abi in ("generic", "host")]
ABI_SETTINGS = {"generic": {"remat": "dots"},
                "host": {"remat": "dots", "fsdp": True}}
# the Fig. 3 cells (benchmarks/fig3_collective_abi.py's two arms) at the
# depth the JAX package's dry run compiles here in seconds
FIG3_LAYERS = 2
FIG3_CELLS = [("deepseek-67b", mesh, abi) for mesh in ("pod", "multipod")
              for abi in ("generic", "host")]


@pytest.fixture(scope="module")
def jax_side():
    """tests/torch_dryrun_jax.py in one subprocess (its XLA sees 512 host
    devices): the shard bytes of ``ARG_CELLS`` and the JAX package's dry
    run of ``FIG3_CELLS``."""
    plan = {"settings": ABI_SETTINGS, "n_layers": FIG3_LAYERS,
            "shards": ARG_CELLS, "dryrun": FIG3_CELLS}
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_dryrun_jax.py"),
         json.dumps(plan)], capture_output=True, text=True, timeout=600,
        env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_leaf_bytes(tree) -> dict:
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif t is not None:
            out["/".join(path)] = t.nbytes
    walk(tree, ())
    return out


def test_argument_bytes_match_jax_shard_shapes(jax_side):
    """deepseek-67b and llama4-scout-17b-a16e, ``train_4k`` on the pod
    and multipod meshes, generic and host + fsdp: every leaf of this
    rank's params and optimizer state (``NamedSharding.local_shape``, as
    ``lower_step`` builds them) has the bytes of the JAX package's
    ``shard_shape`` of the same leaf, exactly (no leaf differs: every
    leaf divides on these meshes, so Queue 3 item 13 does not arise)."""
    want = jax_side["shards"]
    for arch, mesh_name, abi in ARG_CELLS:
        img = dryrun.build_image(arch, "train_4k", mesh_name,
                                 collectives=abi,
                                 settings=ABI_SETTINGS[abi])
        with fake_platform_mesh(mesh_name) as mesh:
            c = Container(img, platform=mesh_name, mesh=mesh,
                          device="meta")
            params = c._rank_params()
            got = {"params": _port_leaf_bytes(params),
                   "opt": _port_leaf_bytes(c.init_opt_state(params))}
        w = want["|".join((arch, mesh_name, abi))]
        for part in ("params", "opt"):
            assert got[part] == w[part], (arch, mesh_name, abi, part, {
                k: (got[part].get(k), w[part].get(k))
                for k in set(got[part]) | set(w[part])
                if got[part].get(k) != w[part].get(k)})


def test_fig3_arms_order_as_the_jax_dry_run(jax_side):
    """Fig. 3's two arms (generic; host + fsdp) on deepseek-67b
    ``train_4k`` at 2 layers, the port's dry run beside the JAX
    package's: no byte crosses a pod on the pod mesh, some do on the
    multipod mesh, and host + fsdp's wire bytes (pod and multipod) and
    cross-pod bytes (multipod) stand on the same side of generic's in
    both. The bytes themselves differ (XLA's partitioner picks its own
    collectives and dtypes; the port's are its explicit ones), so the
    ordering, the quantity Fig. 3 reads, is what is held."""
    ref = jax_side["dryrun"]
    port = {}
    for arch, mesh, abi in FIG3_CELLS:
        rec = dryrun.run_cell(arch, "train_4k", mesh, collectives=abi,
                              settings=ABI_SETTINGS[abi],
                              arch_overrides={"n_layers": FIG3_LAYERS},
                              probes=False)
        port["|".join((arch, mesh, abi))] = {
            "wire": rec["cost"]["wire_bytes_per_device"],
            "cross_pod": rec["cost"]["cross_pod_bytes_per_device"]}
    for side in (port, ref):
        assert all(side[f"deepseek-67b|pod|{abi}"]["cross_pod"] == 0
                   for abi in ABI_SETTINGS)
        assert all(side[f"deepseek-67b|multipod|{abi}"]["cross_pod"] > 0
                   for abi in ABI_SETTINGS)

    def host_above(side, mesh, key):
        cell = f"deepseek-67b|{mesh}|"
        return side[cell + "host"][key] > side[cell + "generic"][key]

    for mesh, key in (("pod", "wire"), ("multipod", "wire"),
                      ("multipod", "cross_pod")):
        assert host_above(port, mesh, key) == host_above(ref, mesh, key), (
            mesh, key, port, ref)


def test_lower_step_arguments_are_params_opt_state_and_rows():
    """``lower_step``'s argument bytes: this rank's params and optimizer
    state plus its rows of the batch; the in-place update aliases them."""
    img = _image("llama3.2-3b-smoke", "train_4k", batch=4)
    with fake_job(2):
        mesh = make_mesh((2, 1), ("data", "model"))
        c = Container(img, platform="local", mesh=mesh, device="meta")
        low = c.lower_step("train")
        params = c._rank_params()
        opt = c.init_opt_state(params)
        rows = sum(t.nbytes for t in c.input_specs("train")["batch"].values())
    state = sum(t.nbytes for t in tree_leaves({"p": params, "o": opt}))
    mem = low.memory()
    assert rows == 2 * 16 * 8 * 2                 # 2 rows of tokens, labels
    assert mem["argument_bytes"] == state + rows
    assert mem["alias_bytes"] == state
    assert mem["resident_bytes"] == state + rows + low.counter.peak


# -- (9) serve cells -------------------------------------------------------------------

SERVE_ARCHS = {"llama3.2-3b-smoke": ("prefill_32k", "decode_32k"),
               "recurrentgemma-2b-smoke": ("prefill_32k", "decode_32k",
                                           "long_500k"),
               "musicgen-medium-smoke": ("prefill_32k", "decode_32k")}


@pytest.mark.parametrize("arch", sorted(SERVE_ARCHS))
def test_serve_cells_trace_on_pod_and_multipod(tmp_path, arch):
    """The serve cells trace (``ok``) on one rank of the pod (16 x 16)
    and multipod (2 x 16 x 16) meshes, unit probes included, and on
    ``local``: the rank holds 1/16 of the KV cache's ``kv_heads`` and its
    rows of the batch (long_500k's one row stays whole on every replica),
    ``fits_hbm`` is the resident bytes against one card's, and on
    ``local`` llama's prefill runs its two flash-attention calls and its
    decode no kernel (a contiguous cache)."""
    shapes = SERVE_ARCHS[arch]
    dryrun.main(["--arch", arch, "--shape", ",".join(shapes), "--mesh",
                 "pod,multipod,local", "--out", str(tmp_path)])
    recs = {(r["shape"], r["mesh"]): r for r in report.load(str(tmp_path))}
    for shape in shapes:
        batch = SHAPE_CELLS[shape].global_batch
        for mesh, reps in (("pod", 16), ("multipod", 32), ("local", 1)):
            rec = recs[(shape, mesh)]
            assert rec["status"] == "ok", rec.get("error")
            assert rec["memory"]["fits_hbm"] == (
                rec["memory"]["resident_bytes_per_device"] <= 80e9)
            assert len(rec["probes"]) == len(rec["stages"])
            tp = 1 if mesh == "local" else 16
            rows = reps if batch % reps == 0 else 1
            cache = rec["cache"]
            assert cache["kv_bytes"] > 0
            assert cache["kv_bytes_per_device"] * tp * rows == \
                cache["kv_bytes"], (shape, mesh, cache)
            assert 0 < cache["bytes_per_device"] < cache["bytes"] or \
                mesh == "local"
    if arch == "llama3.2-3b-smoke":
        assert recs[("prefill_32k", "local")]["kernel_calls"] == {
            "flash_attention_fwd": 2}
        assert recs[("decode_32k", "local")]["kernel_calls"] == {}


# -- (10) the command line, without jax ---------------------------------------------

NO_JAX_SCRIPT = """
import runpy, sys
out = sys.argv[1]
cell = ["--arch", "llama3.2-3b-smoke", "--shape", "train_4k", "--mesh", "pod"]
for argv in (["repro_torch.launch.dryrun", *cell, "--out", out],
             ["repro_torch.launch.dryrun", *cell, "--out", out],
             ["repro_torch.launch.report", "--dir", out, "--md"],
             ["repro_torch.launch.opdump", *cell, "--top", "60"]):
    sys.argv = argv
    print("== " + argv[0], flush=True)
    runpy.run_module(argv[0], run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print("imported", bad)
"""


def test_cli_without_jax(tmp_path):
    """The dry run, its cached rerun, the report (the port's artifact
    beside one in the reference's format) and opdump, in a process where
    ``import jax`` and ``import repro`` raise; the JAX package's report
    renders the port's artifact too."""
    poison = tmp_path / "poison"
    for name in ("jax", "repro"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable here')\n")
    out = tmp_path / "dryrun"
    out.mkdir()
    # a record as the JAX package writes it (its keys only), next to the
    # port's
    ref_rec = {"arch": "llama3.2-3b", "shape": "train_4k", "mesh": "pod",
               "kind": "train", "status": "ok",
               "memory": {"resident_bytes_per_device": 2**31,
                          "fits_hbm": True},
               "roofline": {"compute_s": 1.0, "memory_s": 0.5,
                            "collective_s": 0.25, "dominant": "compute",
                            "useful_flops_fraction": 0.9,
                            "roofline_fraction": 0.8}}
    (out / "llama3.2-3b__train_4k__pod.json").write_text(json.dumps(ref_rec))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(poison), str(REPO / "src")])}
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX_SCRIPT, str(out)], cwd=str(tmp_path),
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    text = proc.stdout
    name = "llama3.2-3b-smoke__train_4k__pod.json"
    assert f"[ok " in text and f"[skip-cached] {name}" in text
    rec = json.loads((out / name).read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    # 2 layers: each forward twice (remat), the backward kernels once
    assert rec["kernel_calls"] == {"flash_attention_fwd": 4,
                                   "flash_attention_bwd": 2}
    assert rec["cost"]["collective_bytes_by_label"]["tp"]["all_reduce"] > 0
    table = text.split("== repro_torch.launch.report")[1]
    assert "| llama3.2-3b-smoke | train_4k" in table
    assert "| llama3.2-3b       | train_4k" in table
    assert "# unit probe llama3.2-3b-smoke/train_4k/pod stage0 x2" in text
    assert "kernel:flash_attention_fwd" in text
    assert "imported []" in text
    from repro.launch import report as ref_report
    both = ref_report.table(ref_report.load(str(out)))
    assert "llama3.2-3b-smoke" in both and both.count("train_4k") == 2


# -- the other lowering entry points -------------------------------------------

def test_cache_specs_and_compile_step():
    """``slot_cache_specs``/``paged_cache_specs`` are meta tensors of the
    caches ``init_slot_cache``/``init_paged_cache`` make (shapes and
    dtypes, a float32 state in a float32 image too), their shardings split
    the kv heads over a model axis; ``compile_step`` builds each kind's
    step once through the CompileCache and hits it after."""
    from repro_torch.core.compile_cache import CompileCache
    img = _image("llama3.2-3b-smoke", "decode_32k")
    c = Container(img, platform="cpu", compile_cache=CompileCache())
    for specs, real in ((c.slot_cache_specs(2, 8), c.init_slot_cache(2, 8)),
                        (c.paged_cache_specs(6, 4),
                         c.init_paged_cache(6, 4))):
        assert all(s.is_meta for s in tree_leaves(specs))
        assert [(tuple(s.shape), s.dtype) for s in tree_leaves(specs)] == \
            [(tuple(r.shape), r.dtype) for r in tree_leaves(real)]
    with fake_job(2):
        mesh = make_mesh((1, 2), ("data", "model"))
        tp = Container(img, platform="local", mesh=mesh, device="meta")
        k = tp.slot_cache_shardings(2, 8)["stage0"]["b0"]["k"]
        assert k.local_shape((2, 2, 8, 2, 16)) == (2, 2, 8, 1, 16)
        pk = tp.paged_cache_shardings(6, 4)["stage0"]["b0"]["k"]
        assert pk.local_shape((2, 2, 6, 4, 16)) == (2, 1, 6, 4, 16)
    for kind in ("train", "prefill", "decode"):
        fn = c.compile_step(kind)
        assert callable(fn) and c.compile_step(kind) is fn
    assert (c.compile_cache.stats.misses,
            c.compile_cache.stats.hits_l1) == (3, 3)
