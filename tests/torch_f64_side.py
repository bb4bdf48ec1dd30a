"""One side of tests/test_torch_rgemma_f64.py (not collected: the test runs
it in a subprocess, once per package):

    python tests/torch_f64_side.py jax|port float32|float64 WORKDIR

It takes recurrentgemma-2b-smoke's 3 training steps of tests/test_torch_tp.py
(no model axis, one process) from ``WORKDIR/w0.npz`` on the batches
``WORKDIR/b{i}.npz``, in float32 as the image says, or with every float32
of the package raised to float64: ``jax_enable_x64`` and
``jax.numpy.float32`` pointed at float64 on the JAX side; torch's
``float32`` name, ``Tensor.float`` and the default dtype pointed at float64
on the port's (both packages cast to float32 by name in the loss, the
optimizer and the RG-LRU's gates). The patch is made before the package
is imported, so its default arguments take float64 too, and lasts as long
as this process. The final params go to ``WORKDIR/{side}-{precision}.npz``.
"""

import sys
from pathlib import Path

import numpy as np

IMAGEFILE = """
FROM scratch
ARCH recurrentgemma-2b-smoke
SHAPE train_4k seq_len=16 global_batch=8
MESH local
PRECISION compute={dt} params={dt}
COLLECTIVES generic
SET optimizer={{"lr":0.005,"warmup_steps":2,"total_steps":50}}
"""
STEPS = 3


def _batches(work: Path) -> list:
    return [dict(np.load(work / f"b{i}.npz")) for i in range(STEPS)]


def jax_side(work: Path, dt: str) -> None:
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    if dt == "float64":
        jnp.float32 = jnp.float64

    from repro.core.runtime import Runtime
    w0 = dict(np.load(work / "w0.npz"))
    rt = Runtime(work / f"jrt-{dt}")
    c = rt.run(rt.build(IMAGEFILE.format(dt=dt)))
    paths, treedef = jax.tree_util.tree_flatten_with_path(
        c.abstract_params())
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(w0[jax.tree_util.keystr(p)], dt) for p, _ in paths])
    opt, step = c.init_opt_state(params), jax.jit(c.train_step_fn())
    for b in _batches(work):
        params, opt, _ = step(params, opt, b)
    np.savez(work / f"jax-{dt}.npz", **{
        jax.tree_util.keystr(p): np.asarray(v, np.float64)
        for p, v in jax.tree_util.tree_flatten_with_path(params)[0]})


def port_side(work: Path, dt: str) -> None:
    import torch
    if dt == "float64":
        torch.set_default_dtype(torch.float64)
        torch.float32 = torch.float64
        torch.Tensor.float = torch.Tensor.double

    from repro_torch.checkpoint.store import _flatten, _unflatten
    from repro_torch.core.runtime import Runtime
    w0 = dict(np.load(work / "w0.npz"))
    rt = Runtime(work / f"trt-{dt}")
    c = rt.run(rt.build(IMAGEFILE.format(dt=dt)), platform="cpu")
    params = c.load_params(_unflatten(c.param_defs, {
        k: torch.from_numpy(v) for k, v in w0.items()}))
    opt, step = c.init_opt_state(params), c.train_step_fn()
    for b in _batches(work):
        params, opt, _ = step(params, opt, b)
    np.savez(work / f"port-{dt}.npz", **{
        p: t.detach().double().numpy() for p, t in _flatten(params)})


if __name__ == "__main__":
    {"jax": jax_side, "port": port_side}[sys.argv[1]](Path(sys.argv[3]),
                                                      sys.argv[2])
