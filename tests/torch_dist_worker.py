"""One rank of a torch.distributed job for tests/test_torch_dist.py and
tests/test_torch_tp.py (not collected: the tests spawn it, one process a
rank, with ``jax`` and ``repro`` unimportable):

    python tests/torch_dist_worker.py JOB RANK WORLD WORKDIR

It joins a gloo group through ``file://WORKDIR/pg-JOB`` (parallel test
workers never share a TCP port), runs the job's scenarios from
``WORKDIR/plan.json`` on the port, and rank 0 writes what they give to
``WORKDIR/JOB.json`` and ``WORKDIR/JOB-*.npz``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import _flatten
from repro_torch.core.abi import (all_gather, make_abi,
                                  reduce_scatter_mean, replica_mean)
from repro_torch.core.runtime import Runtime
from repro_torch.dist.mesh import make_mesh
from repro_torch.dist.sharding import NamedSharding, ShardingRules, safe_spec
from repro_torch.launch.train import main as train_main
from repro_torch.train.compression import powersgd_init, powersgd_sync
from repro_torch.train.train_step import TrainStepBuilder


def _load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _numpy_tree(tree) -> dict:
    return {p: t.detach().float().numpy() for p, t in _flatten(tree)}


def _run(step, params, opt, batches, mesh, label) -> tuple[list, dict]:
    """Steps over the global batches: per step loss, grad_norm and the
    bytes the mesh's counter gained under ``label``."""
    rec = []
    for b in batches:
        before = mesh.stats.total(label)
        params, opt, m = step(params, opt, b)
        rec.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "wire": mesh.stats.total(label) - before})
    return rec, params


def _container(rt: Runtime, imagefile: str, weights: dict,
               platform: str = "cpu"):
    """A Container of the job (every rank builds the image in its own
    root) and the given weights loaded into it."""
    c = rt.run(rt.build(imagefile), platform=platform)
    return c, c.load_params(_unflat(c.param_defs, weights))


def _unflat(defs, flat: dict):
    """A param tree shaped like ``defs`` from keystr-path arrays."""
    from repro_torch.checkpoint.store import _unflatten
    return _unflatten(defs, flat)


def _specs(tree) -> dict:
    return {p: [list(e) if isinstance(e, tuple) else e for e in sh.spec]
            for p, sh in _flatten(tree)}


def job_world4(rank: int, world: int, work: Path, plan: dict) -> dict:
    out: dict = {"abis": {}, "masked": {}, "hier": {}}
    weights = _load(work / "params.npz")
    batches = [_load(work / f"batch{i}.npz") for i in range(plan["steps"])]
    rt = Runtime(work / f"rt-{rank}")
    arrays = {}

    # (b) every ABI on the local (4, 1) mesh, 3 steps from the same weights
    for name, imagefile in plan["abis"].items():
        c, params = _container(rt, imagefile, weights)
        opt = c.init_opt_state(params)
        if "comm" in opt:
            q = _load(work / "jax_q.npz")
            opt["comm"]["q"] = _unflat(opt["comm"]["q"], {
                p: torch.from_numpy(q[p])[None] for p in q})
        rec, params = _run(c.train_step_fn(), params, opt, batches, c.mesh,
                           c.abi.name)
        out["abis"][name] = {"steps": rec, "by_op": c.mesh.stats.bytes,
                             "opt_specs": _specs(c.opt_state_shardings()),
                             "param_specs": _specs(c.param_shardings()),
                             "m_local": {p: list(t.shape) for p, t in
                                         _flatten(opt["m"])}}
        arrays.update({f"{name}/{p}": a
                       for p, a in _numpy_tree(params).items()})

    # (c) explicit means on a (pod 2, data 2, model 1) mesh
    mesh22 = make_mesh((2, 2, 1), ("pod", "data", "model"))
    for name, kw in plan["hier"].items():
        c, params = _container(rt, plan["abis"]["generic"], weights)
        abi = make_abi("host", mode="explicit", **kw)
        mesh22.stats.reset()
        step = TrainStepBuilder(model=c.model, abi=abi, opt=c.opt,
                                mesh=mesh22).build()
        rec, params = _run(step, params, c.init_opt_state(params), batches,
                           mesh22, abi.name)
        out["hier"][name] = {"steps": rec, "by_op": mesh22.stats.bytes}
        arrays.update({f"hier_{name}/{p}": a
                       for p, a in _numpy_tree(params).items()})

    # ZeRO-1 parts that two ranks share: pod divides 6, pod x data not
    sh = NamedSharding(mesh22, safe_spec((6, 4), ("embed", None), mesh22,
                                         ShardingRules.default(fsdp=True)))
    x = torch.arange(24.0).reshape(6, 4) * (rank + 1)
    part = reduce_scatter_mean(x, sh, "shared")
    out["shared_parts"] = {"spec": list(sh.spec), "part": part.tolist(),
                           "full": all_gather(part, sh, "shared").tolist()}

    # (d) a loss mask with unequal counts on the ranks
    masks = [_load(work / f"mask{i}.npz")["loss_mask"]
             for i in range(plan["steps"])]
    for name, imagefile in plan["masked"].items():
        c, params = _container(rt, imagefile, weights)
        mb = [{**b, "loss_mask": m} for b, m in zip(batches, masks)]
        rec, params = _run(c.train_step_fn(), params,
                           c.init_opt_state(params), mb, c.mesh, c.abi.name)
        out["masked"][name] = {"steps": rec}
        arrays.update({f"masked_{name}/{p}": a
                       for p, a in _numpy_tree(params).items()})

    # (e) PowerSGD's wire on one 512 x 512 gradient at rank 4
    c, _ = _container(rt, plan["abis"]["generic"], weights)
    g = {"w": torch.from_numpy(_load(work / "g512.npz")["w"])}
    replica_mean(g["w"], ("data",), c.mesh, "plain")
    powersgd_sync(g, powersgd_init(g, 4), ("data",), 4, c.mesh, "powersgd")
    out["wire512"] = {k: c.mesh.stats.total(k) for k in ("plain",
                                                         "powersgd")}

    # (g) an MoE arch on more than one rank
    try:
        _container(rt, plan["moe"], {})
        out["moe_error"] = None
    except NotImplementedError as e:
        out["moe_error"] = str(e)

    # (f) ZeRO-1 through launch/train: a straight 4-step run, and 2 steps
    # checkpointed for the 2-rank and 1-process resumes
    imagefile = work / "Imagefile.zero1"
    common = ["--image", str(imagefile), "--platform", "cpu"]
    out["straight"] = train_main(common + ["--root", str(work / "straight"),
                                           "--steps", "4"])["losses"]
    out["first"] = train_main(common + ["--root", str(work / "chain"),
                                        "--steps", "2", "--ckpt-every", "2"]
                              )["losses"]
    if rank == 0:
        np.savez(work / "world4.npz", **arrays)
    return out


def job_world2(rank: int, world: int, work: Path, plan: dict) -> dict:
    """(f) resume the 4-rank chain on 2 ranks for one step."""
    argv = ["--image", str(work / "Imagefile.zero1"), "--platform", "cpu",
            "--root", str(work / "chain"), "--resume", "--steps", "1"]
    res = train_main(argv)
    return {"losses": res["losses"], "start_step": res["start_step"]}


def job_card2(rank: int, world: int, work: Path, plan: dict) -> dict:
    """Two gloo ranks on one card: each ABI's steps and the launches of
    the flash-attention kernel in this rank."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    weights = _load(work / "params.npz")
    batches = [_load(work / f"batch{i}.npz") for i in range(plan["steps"])]
    rt = Runtime(work / f"rt-{rank}")
    out = {"abis": {}}
    for name, imagefile in plan["abis"].items():
        before = fa_ops.launches
        c, params = _container(rt, imagefile, weights, platform="local")
        rec, _ = _run(c.train_step_fn(), params, c.init_opt_state(params),
                      batches, c.mesh, c.abi.name)
        out["abis"][name] = {"steps": rec, "device": str(c.device),
                             "backend": c.mesh.backend,
                             "k2": fa_ops.launches - before}
    return out


def _full(tree, shardings, mesh) -> dict:
    """keystr path -> the whole leaf as float32 numpy, gathered over the
    dims the shardings split."""
    shs = dict(_flatten(shardings))
    return {p: (all_gather(t, shs[p], "gather") if shs[p].split() else t)
            .detach().float().numpy() for p, t in _flatten(tree)}


def _tp_grads(c, params, batch, mesh) -> dict:
    """The generic step's gradient on the global batch at ``params``:
    each rank's model-axis shard of its replica's gradient, meaned over
    the batch axes (an FSDP part arrives meaned from the backward),
    gathered whole."""
    b = TrainStepBuilder(model=c.model, abi=c.abi, opt=c.opt, mesh=mesh)
    grads, _, _ = b._grads(params, b._local_batch(params, batch))
    baxes = ("pod", "data")
    shs = dict(_flatten(c.param_shardings()))
    grads = {p: g.float() if shs[p].split(baxes)
             else replica_mean(g.float(), baxes, mesh, "gather")
             for p, g in _flatten(grads)}
    return _full(_unflat(c.param_defs, grads), c.param_shardings(), mesh)


def job_tp(rank: int, world: int, work: Path, plan: dict) -> dict:
    """tests/test_torch_tp.py: each scenario of ``plan["tp"]["world<N>"]``
    on its (data, model) mesh (one mesh of each shape, made once): 3 steps
    from the given weights with losses, grad norms and the bytes each
    step handed to the ABI's and the model axis's collectives; the final
    params and (where asked) the first step's gradients, gathered whole;
    a checkpoint of step 2 (where asked); the MoE's dropped
    assignments."""
    from repro_torch.checkpoint.elastic import reshard_restore
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.models import moe as moe_mod
    tp = plan["tp"]
    batches = [_load(work / f"batch{i}.npz") for i in range(tp["steps"])]
    rt = Runtime(work / f"rt-{rank}")
    meshes, out, arrays = {}, {}, {}
    drops, real = [], moe_mod.dispatch_positions

    def counting(idx, n_experts, C):
        pos, keep, slot = real(idx, n_experts, C)
        drops.append(int((~keep).sum()))
        return pos, keep, slot
    moe_mod.dispatch_positions = counting
    for sc in tp[f"world{world}"]:
        shape = tuple(sc["shape"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"))
        mesh = meshes[shape]
        weights = _load(work / f"params-{sc['weights']}.npz")
        c = rt.run(rt.build(sc["imagefile"]), platform="cpu", mesh=mesh)
        params = c.load_params(_unflat(c.param_defs, weights))
        rec = {"param_shapes": {p: list(t.shape)
                                for p, t in _flatten(params)},
               "param_specs": _specs(c.param_shardings()),
               "opt_specs": _specs(c.opt_state_shardings())}
        if sc.get("grads"):
            arrays.update({f"{sc['name']}/grad/{p}": a for p, a in
                           _tp_grads(c, params, batches[0], mesh).items()})
        opt = c.init_opt_state(params)
        step, steps = c.train_step_fn(), []
        del drops[:]
        for i, b in enumerate(batches):
            before = {k: mesh.stats.total(k) for k in (c.abi.name, "tp")}
            by_op = json.loads(json.dumps(mesh.stats.bytes))
            tp_by_op = dict(mesh.stats.bytes.get("tp", {}))
            params, opt, m = step(params, opt, b)
            steps.append({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "aux": float(m["aux_loss"]),
                          "wire": mesh.stats.total(c.abi.name)
                          - before[c.abi.name],
                          "tp": mesh.stats.total("tp") - before["tp"],
                          "abi_by_op": {
                              op: n - by_op.get(c.abi.name, {}).get(op, 0)
                              for op, n in mesh.stats.bytes.get(
                                  c.abi.name, {}).items()},
                          "tp_by_op": {
                              op: n - tp_by_op.get(op, 0) for op, n in
                              mesh.stats.bytes.get("tp", {}).items()}})
            if i == 0:
                rec["drops_step1"] = sum(drops)
            if i + 1 == 2 and sc.get("ckpt"):
                sh = {"params": c.param_shardings(),
                      "opt": c.opt_state_shardings()}
                store = CheckpointStore(work / f"ckpt-{sc['name']}",
                                        mesh=mesh)
                state = {"params": params, "opt": opt}
                store.save(2, state, blocking=True, shardings=sh)
                # and back onto this mesh: every rank's parts, exactly
                back = reshard_restore(store, {
                    "params": c.abstract_params(),
                    "opt": c.abstract_opt_state()}, sh, step=2)
                rec["restored_equal"] = all(
                    torch.equal(a, b) for (_, a), (_, b) in
                    zip(_flatten(state), _flatten(back)))
        rec["steps"] = steps
        arrays.update({f"{sc['name']}/{p}": a for p, a in
                       _full(params, c.param_shardings(), mesh).items()})
        out[sc["name"]] = rec
    moe_mod.dispatch_positions = real
    if world == 4 and "cli" in tp:
        # the user's entry point: `cli run` of an FSDP image on the job's
        # local (4, 1) mesh (this process group, as torchrun's would be)
        from repro_torch.cli import main as cli_main
        root = work / "cli-fsdp"
        cli_main(["--root", str(root), "run", str(work / "Imagefile.fsdp"),
                  "--platform", "cpu", "--steps", str(tp["cli"])])
    if rank == 0:
        np.savez(work / f"tp{world}.npz", **arrays)
    return out


JOBS = {"world4": job_world4, "world2": job_world2, "card2": job_card2,
        "tp4": job_tp, "tp2": job_tp}


def main() -> None:
    job, rank, world, work = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/pg-{job}",
                            rank=rank, world_size=world)
    try:
        plan = json.loads((work / "plan.json").read_text())
        out = JOBS[job](rank, world, work, plan)
        if rank == 0:
            (work / f"{job}.json").write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
