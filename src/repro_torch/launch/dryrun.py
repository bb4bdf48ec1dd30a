"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on one rank
(the port of ``repro.launch.dryrun``).

The proof that the distribution config is coherent without the cards:
for the 16 x 16 single-pod mesh and the 2 x 16 x 16 multi-pod mesh, this
process becomes rank 0 of a job of 256 or 512 fake ranks
(``launch.mesh.fake_platform_mesh``: the ``fake`` process-group backend,
the counterpart of the JAX package's
``--xla_force_host_platform_device_count=512``), builds that rank's parts
on the ``meta`` device and runs its real step code once under the counter
(``Container.lower_step``): FLOPs, bytes, kernel calls, collective bytes
(cross-pod ones apart) and the peak of live bytes, without a byte of
data. ``--mesh local`` traces one rank with no job. Nothing touches a
card. The record gives the roofline at H100 constants
(``launch.analysis``) and whether the rank's residency fits one card's
HBM.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch all --shape all --mesh pod,multipod --out results/dryrun

Per-cell JSON artifacts land under --out with the JAX package's names and
keys, and the port's ``kernel_calls`` and, for a serve cell (prefill or
decode), ``cache``: the bytes of the step's cache whole and on this rank
(its rows and its ``kv_heads``/``rnn``/``heads`` blocks), and of its KV
leaves alone. Rerunning skips cells whose artifact already exists. A cell
the port cannot run is recorded as ``failed`` with its error, as the JAX
package records its failures.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.container import Container
from repro_torch.core.image import ImageBuilder
from repro_torch.launch.analysis import HBM_PER_CHIP, model_flops, roofline
from repro_torch.dist.sharding import def_shardings
from repro_torch.launch.mesh import fake_platform_mesh
from repro_torch.models.config import SHAPE_CELLS, long_context_capable
from repro_torch.models.params import tree_leaves

MESH_PLATFORMS = {"pod": "pod", "multipod": "multipod", "local": "local"}


def build_image(arch: str, shape: str, platform: str, *,
                collectives: str = "generic", settings: dict | None = None,
                precision: dict | None = None,
                arch_overrides: dict | None = None,
                collective_options: dict | None = None):
    b = (ImageBuilder.from_scratch()
         .arch(arch, **(arch_overrides or {}))
         .shape(shape)
         .mesh(platform)
         .precision(**(precision or
                       {"params": "float32", "compute": "bfloat16"}))
         .collectives(collectives, **(collective_options or {})))
    if settings:
        b.set(**settings)
    return b.build()


def skip_reason(arch: str, shape: str) -> str | None:
    cfg = get_config(arch)
    if shape == "long_500k" and not long_context_capable(cfg):
        return ("pure full-attention arch: 512k cached decode is quadratic-"
                "cost; cell skipped per assignment (DESIGN.md §4)")
    return None


def cache_bytes(c: Container) -> dict:
    """The bytes of a serve cell's cache (its ``global_batch`` rows of
    ``seq_len`` positions): whole and this rank's part, over every leaf
    and over the KV leaves (those with a ``kv_heads`` dim) alone."""
    defs = c.model.cache_defs(c.cell.global_batch, c.cell.seq_len)
    out = dict.fromkeys(("bytes", "bytes_per_device", "kv_bytes",
                         "kv_bytes_per_device"), 0)
    for d, sh in zip(tree_leaves(defs), tree_leaves(
            def_shardings(defs, c.mesh, c.rules))):
        isz = c.cache_leaf_dtype(d).itemsize
        whole = math.prod(d.shape) * isz
        part = math.prod(sh.local_shape(d.shape)) * isz
        for pre in ("", "kv_") if "kv_heads" in d.logical else ("",):
            out[pre + "bytes"] += whole
            out[pre + "bytes_per_device"] += part
    return out


def run_cell(arch: str, shape: str, platform: str, *,
             collectives: str = "generic", settings: dict | None = None,
             precision: dict | None = None,
             arch_overrides: dict | None = None,
             collective_options: dict | None = None,
             probes: bool = True) -> dict:
    """Trace one cell on rank 0 of its platform's job; returns the result
    record (the JAX package's keys, plus ``kernel_calls``)."""
    t_start = time.perf_counter()
    image = build_image(arch, shape, platform,
                        collectives=collectives, settings=settings,
                        precision=precision, arch_overrides=arch_overrides,
                        collective_options=collective_options)
    with fake_platform_mesh(MESH_PLATFORMS[platform]) as mesh:
        c = Container(image, platform=platform, mesh=mesh, device="meta")
        kind = c.cell.kind
        t_built = time.perf_counter()
        lowered = c.lower_step(kind)
        t_lower = time.perf_counter()
        probe_info = []
        if probes:
            for si, st in enumerate(c.model.stages):
                pl, count = c.lower_unit_probe(si, kind)
                uc = pl.cost()
                probe_info.append({
                    "stage": si, "count": count, "scaled": False,
                    "unit_flops": uc.flops,
                    "unit_bytes": uc.bytes_accessed,
                    "unit_wire_bytes": uc.collectives.wire_bytes(),
                })
        n_dev = mesh.size
        cache = cache_bytes(c) if kind in ("prefill", "decode") else None
    total = lowered.cost()
    mf = model_flops(c.arch, c.cell)
    rl = roofline(total, mf, n_dev)
    mem = lowered.memory()
    resident = mem["resident_bytes"]
    return {
        "arch": arch, "shape": shape, "mesh": platform, "kind": kind,
        "status": "ok",
        "image": image.digest,
        "abi": collectives,
        "settings": settings or {},
        "precision": precision or {"params": "float32", "compute": "bfloat16"},
        "arch_overrides": arch_overrides or {},
        "n_devices": n_dev,
        "seconds": {"lower": t_lower - t_built,
                    "compile": 0.0, "build": t_built - t_start},
        "memory": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "resident_bytes_per_device": resident,
            "hbm_per_chip": HBM_PER_CHIP,
            "fits_hbm": resident <= HBM_PER_CHIP,
        },
        "cost": {
            "flops_per_device": total.flops,
            "bytes_per_device": total.bytes_accessed,
            "collective_bytes_by_op": total.collectives.bytes_by_op,
            "collective_count_by_op": total.collectives.count_by_op,
            "collective_bytes_by_label": total.collectives.bytes,
            "wire_bytes_per_device": total.collectives.wire_bytes(),
            "cross_pod_bytes_per_device": total.collectives.cross_pod_bytes,
        },
        "kernel_calls": lowered.counter.kernel_calls,
        **({"cache": cache} if cache else {}),
        "stages": [st.count for st in c.model.stages],
        "probes": probe_info,
        "roofline": rl.to_dict(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="pod,multipod")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--collectives", default="generic")
    ap.add_argument("--settings", default="")
    ap.add_argument("--precision", default="",
                    help='JSON, e.g. {"params":"bfloat16","compute":"bfloat16"}')
    ap.add_argument("--arch-overrides", default="",
                    help='JSON ModelConfig overrides, e.g. {"attn_score_dtype":"bfloat16"}')
    ap.add_argument("--collective-options", default="",
                    help='JSON ABI options, e.g. {"mode":"explicit","zero1":false}')
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="",
                    help="suffix for artifact filenames (perf variants)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = (list(SHAPE_CELLS) if args.shape == "all"
              else args.shape.split(","))
    meshes = args.mesh.split(",")
    # default: activation checkpointing on (required to fit ANY large train
    # cell; orthogonal to the paper-faithful generic-vs-host ABI axis)
    settings = json.loads(args.settings) if args.settings else {"remat": "dots"}
    precision = json.loads(args.precision) if args.precision else None
    arch_overrides = (json.loads(args.arch_overrides)
                      if args.arch_overrides else None)
    collective_options = (json.loads(args.collective_options)
                          if args.collective_options else None)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                if mesh not in MESH_PLATFORMS:
                    raise SystemExit(f"unknown --mesh {mesh!r}; expected "
                                     f"one of {sorted(MESH_PLATFORMS)}")
                tag = f"-{args.tag}" if args.tag else ""
                name = f"{arch}__{shape}__{mesh}{tag}.json"
                path = out / name
                if path.exists() and not args.force:
                    print(f"[skip-cached] {name}")
                    continue
                reason = skip_reason(arch, shape)
                if reason:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "skipped", "reason": reason}
                    path.write_text(json.dumps(rec, indent=2))
                    n_skip += 1
                    print(f"[skipped]  {name}: {reason[:60]}...")
                    continue
                t0 = time.perf_counter()
                try:
                    rec = run_cell(arch, shape, mesh,
                                   collectives=args.collectives,
                                   settings=settings,
                                   precision=precision,
                                   arch_overrides=arch_overrides,
                                   collective_options=collective_options,
                                   probes=not args.no_probes)
                    path.write_text(json.dumps(rec, indent=2))
                    n_ok += 1
                    rl = rec["roofline"]
                    print(f"[ok {time.perf_counter()-t0:6.1f}s] {name} "
                          f"dom={rl['dominant']:10s} "
                          f"bound={rl['compute_s']:.2e}/{rl['memory_s']:.2e}/"
                          f"{rl['collective_s']:.2e}s "
                          f"mem/dev={rec['memory']['resident_bytes_per_device']/2**30:.2f}GiB")
                except Exception as e:      # recorded: the sweep goes on
                    n_fail += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "failed", "error": str(e),
                           "traceback": traceback.format_exc()}
                    path.write_text(json.dumps(rec, indent=2))
                    print(f"[FAILED {time.perf_counter()-t0:6.1f}s] {name}: "
                          f"{type(e).__name__}: {str(e)[:200]}")
    print(f"\ndone: ok={n_ok} skipped={n_skip} failed={n_fail}")


if __name__ == "__main__":
    main()
