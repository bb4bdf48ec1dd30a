"""The JAX package's side of tests/test_torch_dist.py and
tests/test_torch_tp.py (not collected: the tests run it in a subprocess,
whose XLA sees 4 host devices):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_dist_jax.py WORKDIR

It runs the scenarios of ``WORKDIR/plan.json`` with ``TrainStepBuilder``
over 4-device meshes, from the weights and global batches the test wrote,
and writes ``WORKDIR/jax.json`` (losses, grad norms, optimizer-state
specs) and ``WORKDIR/jax.npz`` (final params).
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


def main() -> None:
    work = Path(sys.argv[1])
    plan = json.loads((work / "plan.json").read_text())
    assert jax.device_count() == 4, jax.devices()
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
