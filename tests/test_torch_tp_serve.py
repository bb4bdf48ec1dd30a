"""Serving on a model axis and from FSDP parts on the port against the
JAX package's serve steps and ``Pod`` over the same (data, model) mesh,
on the CPU.

The port's ranks are gloo processes (``tests/torch_dist_worker.py``'s
``serve4`` and ``serve2`` jobs, 4 and 2 ranks, run at once; ``jax`` and
``repro`` unimportable in them); the JAX side is ``main_serve`` of
``tests/torch_dist_jax.py`` in a subprocess whose XLA sees 4 host
devices (two processes: the steps and the pods), with ``(1, 2)``, ``(1, 4)``, ``(2, 1)`` and ``(2, 2)`` platforms
added to ``repro.dist.mesh.PLATFORMS`` from there. Both serve the JAX
package's seed-0 weights at the mesh's geometry, handed over as numpy,
on the inputs of ``tests/torch_serve_case.py`` (one numpy seed).

(a) The serve steps -- whole-batch ``prefill``, ``prefill_slot``,
``decode_chunk`` and, for the full-attention archs, ``prefill_slot_paged``
without and with a prefix and ``decode_chunk_paged`` -- of
llama3.2-3b-smoke, its 6-head variant padded to 8 at model 4,
moonshot-v1-16b-a3b-smoke, mamba2-2.7b-smoke, recurrentgemma-2b-smoke and
musicgen-medium-smoke at (1, 2) and (1, 4): each rank's vocab slice of the
logits and its part of every cache within STEP_TOL relative L2 of the JAX
step's shard for that device, and the greedy tokens identical. (b) The
same steps of llama at (2, 1) and (2, 2) with ``fsdp=true``, on the rank's
rows. (c) Pods on (1, 2) and (1, 4). (d) A Pod with a batch axis raises.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_serve_case as case
from test_torch_dist import _poison, _spawn, _wait
from test_torch_tp import _jax_weights

ROOT = Path(__file__).resolve().parent.parent
# float32 steps: the ranks sum each region's partial outputs over the axis
# where one device sums them in one product, a rounding apart (the runs
# show 6.8e-7 at most, moonshot's logits at (1, 2), over 538 leaf parts)
STEP_TOL = 1e-5
TOKENS = ("['first']", "['toks']")


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve")
    plan = {"serve": {"steps": case.STEPS, "pods": case.PODS}}
    (work / "plan.json").write_text(json.dumps(plan))
    for key, (arch, tp) in case.WEIGHTS.items():
        np.savez(work / f"params-{key}.npz", **_jax_weights(arch, tp))
    src = str(ROOT / "src")
    port_env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(_poison(work / "poison")), src]), "OMP_NUM_THREADS": "1"}
    # XLA's CPU backend at optimisation level 0: the steps' compiles take
    # 40% less CPU time and the same values within STEP_TOL
    jax_env = {**os.environ, "PYTHONPATH": src, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                            "--xla_disable_hlo_passes=all-reduce-promotion "
                            "--xla_backend_optimization_level=0"}
    # the JAX side in two processes, the steps' and the pods'
    jprocs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_jax.py"),
         str(work), part], env=jax_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for part in ("steps", "pods")]
    try:
        ranks = _spawn("serve4", 4, work, port_env) + _spawn(
            "serve2", 2, work, port_env)
        _wait(ranks, "the port's ranks")
    finally:
        _wait(jprocs, "the JAX side")
    port = {}
    for world in (4, 2):
        for r in range(world):
            with np.load(work / f"serve{world}-r{r}.npz") as z:
                port.update({k: z[k] for k in z.files})
    with np.load(work / "jax_serve_steps.npz") as z:
        jax_arrays = {k: z[k] for k in z.files}
    return {"work": work, "port": port, "jax": jax_arrays,
            "jobs": {w: json.loads((work / f"serve{w}.json").read_text())
                     for w in (4, 2)},
            "jax_pods": json.loads(
                (work / "jax_serve_pods.json").read_text())}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _held_pages(sc, rank: int) -> list[int]:
    """The pool pages a rank's rows address in the paged decode (on a
    batch axis above 1 a rank writes its rows' pages only; the pool is
    whole on every data coordinate, as the reference's spec keeps it)."""
    rows = case.rows(case.BANK, sc["mesh"], rank)
    return sorted({p for row in case.TABLE[rows] for p in row if p})


@pytest.mark.parametrize("name", [sc["name"] for sc in case.STEPS])
def test_serve_steps_match_jax(serve_runs, name):
    """(a)/(b): every output of every rank of the case -- logits slice,
    cache parts, first and decoded tokens -- against the JAX step's shard
    on the same mesh coordinates."""
    sc = next(s for s in case.STEPS if s["name"] == name)
    want = {k: v for k, v in serve_runs["jax"].items()
            if k.startswith(name + "/")}
    got = {k: v for k, v in serve_runs["port"].items()
           if k.startswith(name + "/")}
    assert want and set(want) == set(got), sorted(set(want) ^ set(got))
    n_ranks = sc["mesh"][0] * sc["mesh"][1]
    assert {k.split("/")[2].split("[")[0] for k in want} == {
        f"r{r}" for r in range(n_ranks)}
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k.endswith(TOKENS):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        if k.split("/")[1] == "paged_chunk" and sc["mesh"][0] > 1:
            rank = int(k.split("/")[2][1:].split("[")[0])
            pages = _held_pages(sc, rank)
            w, g = w[:, :, pages], g[:, :, pages]
        assert _rel(g, w) <= STEP_TOL, (k, _rel(g, w))


@pytest.mark.parametrize("name", ["mamba_12", "mamba_14"])
def test_ssm_collected_cache_is_the_reference_shard(serve_runs, name):
    """(e) ``ssm_forward(return_cache=True, axis=)``: the collected conv
    tail is the rank's block of the reference's (B, K-1, d_inner + 2
    ssm_state) tail, whose blocks do not line up with the rank's ``xi``
    channels, and the state the rank's heads; both equal the JAX shard
    (within STEP_TOL, in test_serve_steps_match_jax too)."""
    tp = 2 if name.endswith("12") else 4
    for r in range(tp):
        for leaf, dim, whole in (("conv", -1, 160), ("state", 2, 8)):
            k = f"{name}/prefill/r{r}['cache']['stage0']['b0']['{leaf}']"
            w, g = serve_runs["jax"][k], serve_runs["port"][k]
            assert g.shape[dim] * tp == whole
            assert _rel(g, w) <= STEP_TOL, (k, _rel(g, w))


def _pod_runs(serve_runs, name):
    world = 2 if name.endswith("12") else 4
    return [ranks[name] for ranks in serve_runs["jobs"][world]["pods"]]


@pytest.mark.parametrize("name", [sc["name"] for sc in case.PODS])
def test_pod_on_a_model_axis_matches_jax_and_one_process(serve_runs, name,
                                                        tmp_path):
    """(c) A Pod on a (1, tp) mesh of the port's ranks (every rank running
    the same scheduler over the same requests) completes every request
    with tokens, admit ticks and done ticks equal on every rank, equal to
    the JAX package's Pod on the same mesh and to the port's one-process
    Pod; each rank holds its part of the cache."""
    from torch_dist_worker import _serve_pod

    from repro_torch.core.runtime import Runtime
    sc = next(s for s in case.PODS if s["name"] == name)
    ranks = _pod_runs(serve_runs, name)
    assert len(ranks) == sc["mesh"][1]
    keys = ("tokens", "admit", "done", "prefix_hits", "tick")
    for r in ranks[1:]:
        assert {k: r[k] for k in keys} == {k: ranks[0][k] for k in keys}
    want = serve_runs["jax_pods"][name]
    for k in ("tokens", "admit", "done", "prefix_hits"):
        assert ranks[0][k] == want[k], k
    assert all(len(t) == case.POD_NEW for t in want["tokens"])
    if sc["paged"]:
        assert want["prefix_hits"] >= 1
    with np.load(serve_runs["work"] / f"params-{sc['weights']}.npz") as z:
        one = _serve_pod(Runtime(tmp_path / "one"), sc, None, dict(z))
    for k in ("tokens", "admit", "done", "prefix_hits"):
        assert one[k] == want[k], k
    # each rank holds a part of the cache, smaller than one process's
    assert all(r["cache_numel"] < one["cache_numel"] for r in ranks)


def test_pod_with_a_batch_axis_raises_naming_item_13d(serve_runs):
    """(d) A Pod on a (2, 1) mesh raises, naming ROADMAP.md Queue 1 item
    13d (the reference splits the slot bank over ``data`` there)."""
    err = serve_runs["jobs"][2]["batch_axis_error"]
    assert err and "Queue 1 item 13d" in err


@pytest.mark.parametrize("world", [2, 4])
def test_greedy_sample_is_one_processes_argmax(serve_runs, world):
    """The distributed argmax over vocab slices equals ``np.argmax`` of the
    whole row with padded columns masked: the first index of the largest
    value, across ranks (row 0), never a padded column (row 1), within
    and across a rank (row 2); every rank returns it."""
    x = case.tie_logits()
    x[:, case.TIE_VOCAB:] = -np.inf
    want = [int(i) for i in np.argmax(x, axis=1)]
    assert want == [70, 10, 5]
    assert serve_runs["jobs"][world]["ties"] == [want] * world
