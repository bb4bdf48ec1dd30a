"""The JAX package's side of tests/test_torch_dist.py and
tests/test_torch_tp.py (not collected: the tests run it in a subprocess,
whose XLA sees 4 host devices):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_dist_jax.py WORKDIR

It runs the scenarios of ``WORKDIR/plan.json`` with ``TrainStepBuilder``
over 4-device meshes, from the weights and global batches the test wrote,
and writes ``WORKDIR/jax.json`` (losses, grad norms, optimizer-state
specs) and ``WORKDIR/jax.npz`` (final params); for
tests/test_torch_tp_serve.py's plan (``"serve"``) the serve steps and
pods of ``main_serve``.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np

from repro.core.abi import make_abi
from repro.core.runtime import Runtime
from repro.train.optimizer import adamw_init
from repro.train.train_step import TrainStepBuilder


def _load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tree(template, flat: dict):
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [flat[jax.tree_util.keystr(p)] for p, _ in paths])


def _spec(sh) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in sh.spec]


def _run(step, params, opt, batches) -> tuple[list, dict]:
    rec = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        rec.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
    return rec, params


def main_tp(work: Path, plan: dict) -> None:
    """tests/test_torch_tp.py's scenarios: ``Model(cfg, tp, constrain,
    moe_mesh)`` and ``TrainStepBuilder`` over a ``jax.make_mesh`` of each
    scenario's (data, model) shape, from the given weights placed by
    their specs; losses, grad norms, the first step's gradients (the
    implicit path's, on the global batch), the optimizer-state specs and
    the final params."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.dist.sharding import constrain
    from repro.models.params import shardings as def_shardings
    from repro.models.transformer import Model

    tp = plan["tp"]
    batches = [_load(work / f"batch{i}.npz") for i in range(tp["steps"])]
    rt = Runtime(work / "jrt")
    out, arrays = {}, {}
    for sc in tp["jax"]:
        c = rt.run(rt.build(sc["imagefile"]))
        shape = tuple(sc["shape"])
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        rules = c.rules
        model = Model(
            c.arch, tp=shape[1],
            constrain=lambda x, logical, mesh=mesh: constrain(
                x, logical, mesh, rules),
            remat=str(c.settings.get("remat", "none")),
            act_dtype=jnp.dtype(c.image.config()["precision"]["compute"]),
            moe_mesh=mesh if c.arch.n_experts and shape[1] > 1 else None)
        defs = model.param_defs()
        weights = _load(work / f"params-{sc['weights']}.npz")
        params = jax.device_put(_tree(defs, weights),
                                def_shardings(defs, mesh, rules))
        ps = def_shardings(defs, mesh, c.opt_rules)
        opt = jax.jit(adamw_init, out_shardings={
            "m": ps, "v": ps, "step": NamedSharding(mesh, P())})(params)
        b = TrainStepBuilder(model=model, mesh=mesh, rules=rules,
                             abi=c.abi, opt=c.opt)
        if sc.get("grads"):
            g = jax.jit(lambda p, x: b._grads(p, x)[0])(params, batches[0])
            arrays.update({f"{sc['name']}/grad/{k}": np.asarray(v,
                                                                np.float32)
                           for k, v in _flat(g).items()})
        rec, params = _run(jax.jit(b.build()), params, opt, batches)
        out[sc["name"]] = {"steps": rec,
                           "opt_specs": {k: _spec(v) for k, v in
                                         _flat(ps).items()},
                           "param_specs": {k: _spec(v) for k, v in _flat(
                               def_shardings(defs, mesh, rules)).items()},
                           "param_shapes": {k: list(v.shape) for k, v in
                                            _flat(params).items()}}
        arrays.update({f"{sc['name']}/{k}": np.asarray(v, np.float32)
                       for k, v in _flat(params).items()})
    (work / "jax.json").write_text(json.dumps(out))
    np.savez(work / "jax.npz", **arrays)


def _rank_parts(tree, mesh, prefix: str, out: dict) -> None:
    """Each rank's part of every leaf of ``tree`` (a rank numbered
    row-major over the (data, model) mesh, as the port's are), as
    ``out[f"{prefix}/r{rank}{keystr}"]``."""
    coords = {d: (i, j) for (i, j), d in np.ndenumerate(mesh.devices)}
    for path, a in _flat(tree).items():
        for sh in a.addressable_shards:
            i, j = coords[sh.device]
            out[f"{prefix}/r{i * mesh.shape['model'] + j}{path}"] = \
                np.asarray(sh.data, np.float32)


def main_serve(work: Path, plan: dict) -> None:
    """tests/test_torch_tp_serve.py's scenarios on the JAX package: the
    step cases through ``Container.lower_serve_step(...).compile()`` and
    the pod cases through ``Pod`` + ``ContinuousScheduler``, each on a
    platform of its (data, model) shape registered in
    ``repro.dist.mesh.PLATFORMS`` from here (the package is not edited).
    Writes every rank's part of each output to ``jax_serve.npz`` and the
    pods' tokens and ticks to ``jax_serve.json`` (a process given only the
    steps or only the pods writes ``jax_serve_steps.npz`` or
    ``jax_serve_pods.json``)."""
    import jax.numpy as jnp

    import torch_serve_case as case
    from repro.dist import mesh as jmesh
    from repro.orchestrator import ContinuousScheduler, GenRequest, Pod
    from repro.orchestrator.scheduler import (_insert_pages_jit,
                                              _insert_slot_jit)

    for shape in {tuple(c["mesh"]) for c in plan["steps"] + plan["pods"]}:
        jmesh.PLATFORMS[case.mesh_name(shape)] = {
            "axes": ("data", "model"), "shape": shape}
    rt = Runtime(work / "jrt-serve")
    arrays, pods = {}, {}
    for sc in plan["steps"]:
        c = rt.run(rt.build(case.imagefile(sc, case.mesh_name(sc["mesh"]))))
        weights = _load(work / f"params-{sc['weights']}.npz")
        params = jax.device_put(_tree(c.abstract_params(), weights),
                                c.param_shardings())
        fe_len = c.arch.frontend_len if c.arch.frontend else 0
        x = case.step_inputs(c.arch.vocab_size, c.arch.d_model, fe_len,
                             sc["arch"])
        name = sc["name"]

        def put(prefix, tree):
            _rank_parts(tree, c.mesh, f"{name}/{prefix}", arrays)

        if sc["prefill"]:
            f = c.lower_serve_step("prefill", batch=2, prompt_len=case.P,
                                   cache_len=case.CACHE).compile()
            put("prefill", dict(zip(("logits", "cache"),
                                    f(params, x["prefill"]))))
        f = c.lower_serve_step("prefill_slot", prompt_len=case.P,
                               cache_len=case.CACHE,
                               frontend_len=fe_len or None).compile()
        args = (x["fe"], np.int32(fe_len)) if fe_len else ()
        first, small = f(params, x["slot"], x["length"], *args)
        put("slot", {"first": first, "cache": small})
        bank = _insert_slot_jit(c.init_slot_cache(case.BANK, case.CACHE),
                                small, jnp.int32(case.SLOT))
        tok = np.zeros((case.BANK, 1), np.int32)
        tok[case.SLOT, 0] = int(first[0])
        pos = np.zeros((case.BANK,), np.int32)
        pos[case.SLOT] = fe_len + int(x["length"])
        f = c.lower_serve_step("decode_chunk", batch=case.BANK,
                               cache_len=case.CACHE,
                               gen_steps=case.GEN).compile()
        toks, _, _, bank = f(params, bank, tok, pos)
        put("chunk", {"toks": toks, "cache": bank})
        if sc["paged"]:
            kw = dict(page_size=case.PAGE, n_pages=case.N_PAGES)
            pool = c.init_paged_cache(case.N_PAGES, case.PAGE)
            f = c.lower_serve_step("prefill_slot_paged", prompt_len=case.PA,
                                   **kw).compile()
            first_a, small = f(params, x["paged_a"], np.int32(case.PA))
            put("paged_a", {"first": first_a, "cache": small})
            pool = _insert_pages_jit(pool, small,
                                     jnp.asarray(x["table"][0, :3]))
            f = c.lower_serve_step("prefill_slot_paged", prompt_len=case.SUF,
                                   prefix_len=case.PFX, **kw).compile()
            first_b, small = f(params, pool, x["paged_b"][:, case.PFX:],
                               np.int32(case.SUF), x["table"][1, :2])
            put("paged_b", {"first": first_b, "cache": small})
            pool = _insert_pages_jit(pool, small,
                                     jnp.asarray(x["table"][1, 2:3]))
            f = c.lower_serve_step("decode_chunk_paged", batch=case.BANK,
                                   max_pages=case.MAX_PAGES,
                                   gen_steps=case.GEN, **kw).compile()
            tok = np.asarray([[int(first_a[0])], [int(first_b[0])]],
                             np.int32)
            pos = np.full((case.BANK,), case.PA, np.int32)
            toks, _, _, pool = f(params, pool, tok, pos, x["table"])
            put("paged_chunk", {"toks": toks, "cache": pool})
    for sc in plan["pods"]:
        tag = sc["name"]
        rt.build(case.imagefile(sc, case.mesh_name(sc["mesh"])), tag=tag)
        kw = (dict(paged=True, page_size=case.PAGE, prefix_cache=True)
              if sc["paged"] else {})
        pod = Pod(rt, tag, replicas=1, n_slots=case.POD_SLOTS,
                  max_len=case.POD_MAX_LEN, **kw)
        vocab = pod.engines[0].container.arch.vocab_size
        reqs = [GenRequest(**r) for r in case.requests_spec(vocab,
                                                             sc["paged"])]
        sched = ContinuousScheduler(pod)
        sched.submit(reqs)
        sched.run(max_ticks=1000)
        pods[tag] = {"tokens": [list(map(int, r.tokens)) for r in reqs],
                     "admit": [r.admit_tick for r in reqs],
                     "done": [r.done_tick for r in reqs],
                     "prefix_hits": pod.engines[0].prefix_hits}
    if plan["pods"]:
        (work / "jax_serve_pods.json").write_text(json.dumps(pods))
    if plan["steps"]:
        np.savez(work / "jax_serve_steps.npz", **arrays)


def main() -> None:
    work = Path(sys.argv[1])
    plan = json.loads((work / "plan.json").read_text())
    assert jax.device_count() == 4, jax.devices()
    if "serve" in plan:
        part = sys.argv[2] if len(sys.argv) > 2 else None
        return main_serve(work, {k: v if part in (None, k) else []
                                 for k, v in plan["serve"].items()})
    if "tp" in plan:
        return main_tp(work, plan)
    weights = _load(work / "params.npz")
    batches = [_load(work / f"batch{i}.npz") for i in range(plan["steps"])]
    rt = Runtime(work / "jrt")
    out: dict = {"abis": {}, "hier": {}, "masked": {}}
    arrays = {}

    def container(imagefile):
        c = rt.run(rt.build(imagefile))
        params = jax.device_put(_tree(c.abstract_params(), weights),
                                c.param_shardings())
        return c, params

    for name, imagefile in plan["abis"].items():
        c, params = container(imagefile)
        rec, params = _run(jax.jit(c.train_step_fn()), params,
                           c.init_opt_state(params), batches)
        out["abis"][name] = {
            "steps": rec, "mesh": dict(c.mesh.shape),
            "opt_specs": {p: _spec(s) for p, s in
                          _flat(c.opt_state_shardings()).items()}}
        arrays.update({f"{name}/{p}": np.asarray(a, np.float32)
                       for p, a in _flat(params).items()})

    shape = (2, 2, 1)
    axes = ("pod", "data", "model")
    mesh22 = jax.make_mesh(shape, axes, axis_types=(
        jax.sharding.AxisType.Auto,) * 3)
    for name, kw in plan["hier"].items():
        c, params = container(plan["abis"]["generic"])
        params = jax.device_get(params)
        b = TrainStepBuilder(model=c.model, mesh=mesh22, rules=c.rules,
                             abi=make_abi("host", mode="explicit", **kw),
                             opt=c.opt)
        rec, params = _run(jax.jit(b.build()), params, adamw_init(params),
                           batches)
        out["hier"][name] = {"steps": rec}
        arrays.update({f"hier_{name}/{p}": np.asarray(a, np.float32)
                       for p, a in _flat(params).items()})

    masks = [_load(work / f"mask{i}.npz")["loss_mask"]
             for i in range(plan["steps"])]
    for name, imagefile in plan["masked"].items():
        c, params = container(imagefile)
        mb = [{**b, "loss_mask": m} for b, m in zip(batches, masks)]
        rec, params = _run(jax.jit(c.train_step_fn()), params,
                           c.init_opt_state(params), mb)
        out["masked"][name] = {"steps": rec}
        arrays.update({f"masked_{name}/{p}": np.asarray(a, np.float32)
                       for p, a in _flat(params).items()})

    (work / "jax.json").write_text(json.dumps(out))
    np.savez(work / "jax.npz", **arrays)


if __name__ == "__main__":
    main()
