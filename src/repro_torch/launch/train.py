"""Training: the srun-shaped entry point (the port of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --image <tag-or-Imagefile> \\
      [--platform local|cpu] --steps 100
  PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train ...

The paper's `srun shifter --image=... ./demo` analog: one image, any
platform, the host decides where it runs (``local`` is the CUDA cards; the
CPU only when ``--platform cpu`` asks for it). Fault tolerance is on by
default: deterministic data, periodic async checkpoints into the
container overlay, resume from the latest checkpoint (possibly on another
platform or world size -- elastic restart), straggler monitoring with
checkpoint-on-trip. ``--keep N`` bounds the checkpoints on disk (see
``CheckpointStore``); the default keeps all, as the JAX package does.

Under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
/ ``MASTER_PORT`` in the environment) every process is one rank of the
job's mesh (``local``: all of them on ``data``; ``pod`` and ``multipod``:
the JAX package's (16, 16) and (2, 16, 16) meshes, at 256 and 512
ranks): it joins the process group (``nccl`` when every rank of a node
has its own card, else ``gloo``: a function of the topology, never a
fallback), trains on its rows of each global batch and its shard of the
params, and leaves the group at exit. A caller that made the process group itself keeps it.
Rank 0 alone prints, pushes the image, writes the overlay, the metrics
and the checkpoints; into the overlay it also writes ``ranks.json``, each
rank's step and collective seconds, wire bytes, peak device memory and
kernel launches. Without torchrun's environment and without a group it
runs as one process, as before.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from repro_torch.checkpoint.elastic import reshard_restore
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.checkpoint.straggler import StragglerMonitor
from repro_torch.core.imagefile import parse_imagefile
from repro_torch.core.runtime import Runtime
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.mesh import resolve_device


def backend_for(device: torch.device, ranks_on_node: int) -> str:
    """``nccl`` when the ranks are on cards, one card each; ``gloo``
    otherwise (the CPU, or more ranks on a node than it has cards)."""
    if device.type == "cuda" and ranks_on_node <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _join_job(platform: str) -> bool:
    """Join torchrun's job when its environment names one and no group
    exists yet; True when this call made the group."""
    dist = torch.distributed
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    device = resolve_device(platform)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device, int(os.environ.get("LOCAL_WORLD_SIZE", world))),
        init_method="env://", rank=int(os.environ["RANK"]),
        world_size=world)
    return True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True,
                    help="registry tag/digest, or a path to an Imagefile")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--keep", type=int, default=0,
                    help="checkpoints kept on disk (0: all)")
    ap.add_argument("--root", default=".stevedore")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rt = Runtime(args.root)
    dist = torch.distributed
    lead = (dist.get_rank() if dist.is_initialized()
            else int(os.environ.get("RANK", "0"))) == 0
    if Path(args.image).exists():
        text = Path(args.image).read_text()
        image = (rt.build(text) if lead
                 else parse_imagefile(text, registry=rt.registry))
    else:
        image = rt.pull(args.image)
    platform = args.platform or (image.config().get("mesh") or {}).get(
        "platform", "local")
    made_group = _join_job(platform)
    try:
        return _train(rt, image, platform, args)
    finally:
        if made_group:
            torch.distributed.destroy_process_group()


def _train(rt: Runtime, image, platform: str, args) -> dict:
    c = rt.run(image, platform=platform)
    mesh = c.mesh
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    in_job = torch.distributed.is_initialized()
    if in_job and c.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(c.device)
    cell = c.cell
    say(f"[train] image={image.short_digest} arch={c.arch.name} "
        f"platform={c.platform} device={c.device} cell={cell.name} "
        f"abi={c.abi.describe()} mesh={_mesh_txt(mesh)}"
        + (f" ranks={mesh.size} backend={mesh.backend}" if in_job else ""))

    data = SyntheticLM(DataConfig(
        vocab_size=c.arch.vocab_size, seq_len=cell.seq_len,
        global_batch=cell.global_batch, seed=args.seed,
        frontend_len=c.arch.frontend_len, d_model=c.arch.d_model))

    ckpt = mesh.broadcast_object(
        str(_ckpt_dir(c, rt, args.resume)) if mesh.rank == 0 else None)
    store = CheckpointStore(ckpt, keep=args.keep, mesh=mesh)
    sh = {"params": c.param_shardings(), "opt": c.opt_state_shardings()}
    start_step = 0
    if args.resume and store.latest_step() is not None:
        t = {"params": c.abstract_params(), "opt": c.abstract_opt_state()}
        restored = reshard_restore(store, t, sh)
        params, opt = restored["params"], restored["opt"]
        start_step = int(opt["step"])
        say(f"[train] resumed from step {start_step} "
            f"(elastic: device={c.device} ranks={mesh.size} "
            f"mesh={_mesh_txt(mesh)})")
    else:
        params = c.init_params(args.seed)
        opt = c.init_opt_state(params)

    step_fn = c.train_step_fn(donate=True)
    mon = StragglerMonitor()
    last_loss = float("nan")
    losses = {}
    per_step = []
    for i in range(start_step, start_step + args.steps):
        batch = data.batch(i)
        wire0, coll0 = mesh.stats.wire_bytes(c.abi.name), mesh.stats.seconds
        mon.start()
        params, opt, metrics = step_fn(params, opt, batch)
        last_loss = float(metrics["loss"])   # waits for the step's kernels
        timing = mon.stop()
        losses[i + 1] = last_loss
        per_step.append({
            "step": i + 1, "loss": last_loss,
            "seconds": timing["step_seconds"],
            "collective_seconds": mesh.stats.seconds - coll0,
            "wire_bytes": mesh.stats.wire_bytes(c.abi.name) - wire0,
            "grad_norm": float(metrics["grad_norm"])})
        c.log_metrics(i + 1, {**metrics, "step_seconds":
                              timing["step_seconds"],
                              "straggler_flag": timing["flagged"]})
        # rank 0's clock decides, so every rank checkpoints together
        if mesh.broadcast_object(timing["tripped"]):
            say(f"[train] straggler trip at step {i+1}: checkpointing for "
                "drain/replace")
            store.save(i + 1, {"params": params, "opt": opt}, blocking=True,
                       shardings=sh)
        elif (i + 1) % args.ckpt_every == 0:
            store.save(i + 1, {"params": params, "opt": opt}, shardings=sh)
        if (i + 1) % 10 == 0 or i == start_step:
            say(f"[train] step {i+1} loss={last_loss:.4f} "
                f"lr={float(metrics['lr']):.2e} "
                f"t={timing['step_seconds']*1e3:.0f}ms")
    store.wait()
    store.save(start_step + args.steps, {"params": params, "opt": opt},
               blocking=True, shardings=sh)
    if in_job:
        _write_ranks(c, per_step)
    say(f"[train] done at step {start_step + args.steps}; "
        f"overlay={c.overlay}")
    return {"final_loss": last_loss, "overlay": str(c.overlay),
            "steps": start_step + args.steps, "start_step": start_step,
            "losses": losses}


def _mesh_txt(mesh) -> str:
    """``data=2,model=2``: the mesh's axes and sizes."""
    return ",".join(f"{a}={n}" for a, n in mesh.shape.items())


def _write_ranks(c, per_step: list) -> None:
    """Rank 0 writes every rank's record to ``<overlay>/ranks.json``."""
    from repro_torch.kernels import bwd_launch_counts, launch_counts
    cuda = c.device.type == "cuda"
    rec = {"rank": c.mesh.rank, "ranks": c.mesh.size,
           "backend": c.mesh.backend, "device": str(c.device),
           "pid": os.getpid(), "abi": c.abi.describe(), "steps": per_step,
           "wire_bytes_by_op": c.mesh.stats.bytes,
           "peak_memory_bytes": (torch.cuda.max_memory_allocated(c.device)
                                 if cuda else None),
           "kernel_launches": launch_counts(),
           "kernel_bwd_launches": bwd_launch_counts()}
    records = c.mesh.gather_objects(rec)
    if c.mesh.rank == 0:
        (c.overlay / "ranks.json").write_text(json.dumps(records, indent=1))


def _ckpt_dir(c, rt: Runtime, resume: bool) -> Path:
    """Where this run's checkpoints go: its own overlay, or with
    ``resume`` the store of the newest overlay of the same image that
    published one, whose chain the run continues. (Every run is a new
    container with a new overlay, so the JAX package's ``--resume`` looks
    only in an empty store and starts over.)"""
    own = c.overlay / "ckpt"
    if not resume:
        return own
    found = []
    for meta in rt.overlay_root.glob("*/container.json"):
        latest = meta.parent / "ckpt" / "LATEST"
        if latest.exists() and json.loads(
                meta.read_text()).get("image") == c.image.digest:
            found.append((latest.stat().st_mtime, latest.parent))
    return max(found)[1] if found else own


if __name__ == "__main__":
    main()
