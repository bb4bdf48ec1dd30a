"""The JAX package's side of tests/test_torch_dryrun.py (not collected: the
test runs it in a subprocess; it gives its XLA 512 host devices itself):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_dryrun_jax.py PLAN

``PLAN`` is a JSON object (or a file holding one) with two lists of
``train_4k`` cells, each ``[arch, mesh, abi]`` (the collective ABI, and
the key of its image settings in ``settings``):

* ``shards``: every leaf's bytes a device of the params and optimizer
  state (``NamedSharding.shard_shape`` over ``abstract_params()`` /
  ``abstract_opt_state()``, no compile);
* ``dryrun``: the JAX package's dry run of the cell
  (``repro.launch.dryrun.run_cell``, unit probes included) at the plan's
  ``n_layers`` layers (``arch_overrides``): its collective bytes by
  operation, wire and cross-pod bytes a device, and stage 0's unit
  probe's, from which the cell at any depth follows (the dry run's own
  rule: module + (count - 1) x unit).

Prints one JSON object, keyed ``arch|mesh|abi`` under each list's name.
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402

from repro.core.container import Container  # noqa: E402
from repro.launch.analysis import cost_of  # noqa: E402
from repro.launch.dryrun import build_image, run_cell  # noqa: E402


def per_leaf(tree, shardings) -> dict:
    out = {}
    for (path, x), sh in zip(jax.tree_util.tree_leaves_with_path(tree),
                             jax.tree.leaves(shardings)):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[key] = math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
    return out


def shard_bytes(arch: str, mesh: str, abi: str, settings: dict) -> dict:
    c = Container(build_image(arch, "train_4k", mesh, collectives=abi,
                              settings=settings), platform=mesh)
    return {"params": per_leaf(c.abstract_params(), c.param_shardings()),
            "opt": per_leaf(c.abstract_opt_state(), c.opt_state_shardings())}


def _collectives(stats) -> dict:
    return {"bytes_by_op": stats.bytes_by_op, "wire": stats.wire_bytes,
            "cross_pod": stats.cross_pod_bytes}


def dryrun_cell(arch: str, mesh: str, abi: str, settings: dict,
                n_layers: int) -> dict:
    overrides = {"n_layers": n_layers}
    rec = run_cell(arch, "train_4k", mesh, collectives=abi,
                   settings=settings, arch_overrides=overrides)
    c = Container(build_image(arch, "train_4k", mesh, collectives=abi,
                              settings=settings, arch_overrides=overrides),
                  platform=mesh)
    probe, count = c.lower_unit_probe(0, c.cell.kind)
    cost = rec["cost"]
    return {"status": rec["status"], "stages": rec["stages"],
            "bytes_by_op": cost["collective_bytes_by_op"],
            "wire": cost["wire_bytes_per_device"],
            "cross_pod": cost["cross_pod_bytes_per_device"],
            "unit": {"count": count,
                     **_collectives(cost_of(probe.compile()).collectives)}}


def main(argv: list[str]) -> None:
    arg = argv[0]
    plan = json.loads(arg if arg.lstrip().startswith("{")
                      else Path(arg).read_text())
    settings = plan["settings"]
    out = {"shards": {}, "dryrun": {}}
    for arch, mesh, abi in plan.get("shards", []):
        out["shards"]["|".join((arch, mesh, abi))] = shard_bytes(
            arch, mesh, abi, settings[abi])
    for arch, mesh, abi in plan.get("dryrun", []):
        out["dryrun"]["|".join((arch, mesh, abi))] = dryrun_cell(
            arch, mesh, abi, settings[abi], plan["n_layers"])
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
