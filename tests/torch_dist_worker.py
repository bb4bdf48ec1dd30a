"""One rank of a torch.distributed job for tests/test_torch_dist.py,
tests/test_torch_tp.py and tests/test_torch_tp_serve.py (not collected: the tests spawn it, one process a
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
        before = mesh.stats.wire_bytes(label)
        params, opt, m = step(params, opt, b)
        rec.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "wire": mesh.stats.wire_bytes(label) - before})
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
    out["wire512"] = {k: c.mesh.stats.wire_bytes(k) for k in ("plain",
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
            before = {k: mesh.stats.wire_bytes(k) for k in (c.abi.name, "tp")}
            by_op = json.loads(json.dumps(mesh.stats.bytes))
            tp_by_op = dict(mesh.stats.bytes.get("tp", {}))
            params, opt, m = step(params, opt, b)
            steps.append({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "aux": float(m["aux_loss"]),
                          "wire": mesh.stats.wire_bytes(c.abi.name)
                          - before[c.abi.name],
                          "tp": mesh.stats.wire_bytes("tp") - before["tp"],
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


def _serve_steps(c, params, sc, rank: int, arrays: dict) -> None:
    """A step case of tests/torch_serve_case.py on this rank: its rows of
    each batch, its part of every cache, as the JAX package's
    ``main_serve`` runs the case; every output into ``arrays``."""
    import torch_serve_case as case
    from repro_torch.orchestrator.scheduler import (_insert_pages,
                                                    _insert_slot)
    fe_len = c.arch.frontend_len if c.arch.frontend else 0
    x = {k: torch.from_numpy(np.asarray(v)) for k, v in case.step_inputs(
        c.arch.vocab_size, c.arch.d_model, fe_len, sc["arch"]).items()}
    shape = sc["mesh"]
    mine = lambda a: a[case.rows(a.shape[0], shape, rank)]  # noqa: E731

    def put(prefix, tree):
        arrays.update({f"{sc['name']}/{prefix}/r{rank}{p}":
                       t.detach().float().numpy() for p, t in _flatten(tree)})

    if sc["prefill"]:
        f = c.build_serve_step("prefill", batch=2, prompt_len=case.P,
                               cache_len=case.CACHE)
        put("prefill", dict(zip(("logits", "cache"),
                                f(params, mine(x["prefill"])))))
    f = c.build_serve_step("prefill_slot", prompt_len=case.P,
                           cache_len=case.CACHE, frontend_len=fe_len or None)
    args = (x["fe"], fe_len) if fe_len else ()
    first, small = f(params, x["slot"], int(x["length"]), *args)
    put("slot", {"first": first, "cache": small})
    bank = c.init_slot_cache(case.BANK, case.CACHE)
    held = case.rows(case.BANK, shape, rank)
    if held.start <= case.SLOT < held.stop:
        bank = _insert_slot(bank, small, case.SLOT - held.start)
    tok = torch.zeros((case.BANK, 1), dtype=torch.int32)
    tok[case.SLOT, 0] = int(first[0])
    pos = torch.zeros((case.BANK,), dtype=torch.int32)
    pos[case.SLOT] = fe_len + int(x["length"])
    f = c.build_serve_step("decode_chunk", batch=case.BANK,
                           cache_len=case.CACHE, gen_steps=case.GEN)
    toks, _, _, bank = f(params, bank, mine(tok), mine(pos))
    put("chunk", {"toks": toks, "cache": bank})
    if not sc["paged"]:
        return
    kw = dict(page_size=case.PAGE, n_pages=case.N_PAGES)
    pool = c.init_paged_cache(case.N_PAGES, case.PAGE)
    table = x["table"]
    f = c.build_serve_step("prefill_slot_paged", prompt_len=case.PA, **kw)
    first_a, small = f(params, x["paged_a"], case.PA)
    put("paged_a", {"first": first_a, "cache": small})
    pool = _insert_pages(pool, small, table[0, :3])
    f = c.build_serve_step("prefill_slot_paged", prompt_len=case.SUF,
                           prefix_len=case.PFX, **kw)
    first_b, small = f(params, pool, x["paged_b"][:, case.PFX:], case.SUF,
                       table[1, :2])
    put("paged_b", {"first": first_b, "cache": small})
    pool = _insert_pages(pool, small, table[1, 2:3])
    f = c.build_serve_step("decode_chunk_paged", batch=case.BANK,
                           max_pages=case.MAX_PAGES, gen_steps=case.GEN, **kw)
    tok = torch.stack([first_a, first_b]).to(torch.int32)
    pos = torch.full((case.BANK,), case.PA, dtype=torch.int32)
    toks, _, _, pool = f(params, pool, mine(tok), mine(pos), mine(table))
    put("paged_chunk", {"toks": toks, "cache": pool})


def _serve_pod(rt, sc, mesh, weights: dict) -> dict:
    """A pod case of tests/torch_serve_case.py on this job's mesh (or in
    one process, without one), serving ``weights`` (keystr path ->
    array): every request's tokens and ticks."""
    import torch_serve_case as case
    from repro_torch.orchestrator import ContinuousScheduler, GenRequest, Pod
    rt.build(case.imagefile(sc, "local"), tag=sc["name"])
    defs = rt.run(sc["name"], platform="cpu", mesh=mesh).param_defs
    kw = (dict(paged=True, page_size=case.PAGE, prefix_cache=True)
          if sc["paged"] else {})
    pod = Pod(rt, sc["name"], replicas=1, n_slots=case.POD_SLOTS,
              max_len=case.POD_MAX_LEN, platform="cpu", mesh=mesh,
              params=_unflat(defs, weights), **kw)
    eng = pod.engines[0]
    reqs = [GenRequest(**r) for r in case.requests_spec(
        eng.container.arch.vocab_size, sc["paged"])]
    sched = ContinuousScheduler(pod)
    sched.submit(reqs)
    sched.run(max_ticks=1000)
    return {"tokens": [list(map(int, r.tokens)) for r in reqs],
            "admit": [r.admit_tick for r in reqs],
            "done": [r.done_tick for r in reqs],
            "prefix_hits": eng.prefix_hits, "tick": sched.tick,
            "cache_numel": sum(t.numel() for _, t in _flatten(eng.cache))}


def job_serve(rank: int, world: int, work: Path, plan: dict) -> dict:
    """tests/test_torch_tp_serve.py: the step and pod cases of
    ``plan["serve"]`` whose mesh has this job's size (one mesh of each
    shape, made once), every rank's step outputs into
    ``serve{world}-r{rank}.npz`` and every rank's pod records returned;
    on 2 ranks also a Pod on the (2, 1) mesh, which raises."""
    import torch_serve_case as case
    plan = plan["serve"]
    rt = Runtime(work / f"rt-serve{world}-{rank}")
    meshes, arrays, pods = {}, {}, {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"))
        return meshes[shape]
    for sc in plan["steps"]:
        shape = tuple(sc["mesh"])
        if shape[0] * shape[1] == world:
            c = rt.run(rt.build(case.imagefile(sc, "local")),
                       platform="cpu", mesh=mesh_of(shape))
            params = c.load_params(_unflat(c.param_defs, _load(
                work / f"params-{sc['weights']}.npz")))
            _serve_steps(c, params, sc, rank, arrays)
    for sc in plan["pods"]:
        shape = tuple(sc["mesh"])
        if shape[0] * shape[1] == world:
            pods[sc["name"]] = _serve_pod(
                rt, sc, mesh_of(shape),
                _load(work / f"params-{sc['weights']}.npz"))
    out = {"pods": meshes[(1, world)].gather_objects(pods)}
    # the distributed argmax on ties and padded columns
    from repro_torch.dist.sharding import model_axis
    from repro_torch.serve.serve_step import greedy_sample
    axis = model_axis(meshes[(1, world)])
    glob = torch.from_numpy(case.tie_logits())
    n = glob.shape[1] // world
    out["ties"] = axis.mesh.gather_objects(greedy_sample(
        glob[:, axis.coord * n:(axis.coord + 1) * n], case.TIE_VOCAB,
        axis).tolist())
    if world == 2:
        from repro_torch.orchestrator import Pod
        rt.build(case.imagefile(plan["pods"][0], "local"), tag="batch2")
        try:
            Pod(rt, "batch2", replicas=1, platform="cpu",
                mesh=mesh_of((2, 1)))
            out["batch_axis_error"] = None
        except NotImplementedError as e:
            out["batch_axis_error"] = str(e)
    np.savez(work / f"serve{world}-r{rank}.npz", **arrays)
    return out


JOBS = {"world4": job_world4, "world2": job_world2, "card2": job_card2,
        "tp4": job_tp, "tp2": job_tp, "serve4": job_serve,
        "serve2": job_serve}


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
