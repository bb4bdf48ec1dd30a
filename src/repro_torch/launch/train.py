"""Training: the srun-shaped entry point (the port of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --image <tag-or-Imagefile> \\
      [--platform local|cpu] --steps 100

The paper's `srun shifter --image=... ./demo` analog: one image, any
platform, the host decides where it runs (``local`` is ``cuda:0``; the CPU
only when ``--platform cpu`` asks for it). Fault tolerance is on by
default: deterministic data, periodic async checkpoints into the
container overlay, resume from the latest checkpoint (possibly on another
platform -- elastic restart), straggler monitoring with
checkpoint-on-trip. ``--keep N`` bounds the checkpoints on disk (see
``CheckpointStore``); the default keeps all, as the JAX package does.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.checkpoint.elastic import reshard_restore
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.checkpoint.straggler import StragglerMonitor
from repro_torch.core.runtime import Runtime
from repro_torch.data.pipeline import DataConfig, SyntheticLM


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
    if Path(args.image).exists():
        image = rt.build(Path(args.image).read_text())
    else:
        image = rt.pull(args.image)
    c = rt.run(image, platform=args.platform)
    c.ensure_overlay()
    cell = c.cell
    print(f"[train] image={image.short_digest} arch={c.arch.name} "
          f"platform={c.platform} device={c.device} cell={cell.name} "
          f"abi={c.abi.describe()}")

    data = SyntheticLM(DataConfig(
        vocab_size=c.arch.vocab_size, seq_len=cell.seq_len,
        global_batch=cell.global_batch, seed=args.seed,
        frontend_len=c.arch.frontend_len, d_model=c.arch.d_model))

    store = CheckpointStore(_ckpt_dir(c, rt, args.resume), keep=args.keep)
    start_step = 0
    if args.resume and store.latest_step() is not None:
        t = {"params": c.abstract_params(), "opt": c.abstract_opt_state()}
        restored = reshard_restore(store, t, c.device)
        params, opt = restored["params"], restored["opt"]
        start_step = int(opt["step"])
        print(f"[train] resumed from step {start_step} "
              f"(elastic: device={c.device})")
    else:
        params = c.init_params(args.seed)
        opt = c.init_opt_state(params)

    step_fn = c.train_step_fn(donate=True)
    mon = StragglerMonitor()
    last_loss = float("nan")
    losses = {}
    for i in range(start_step, start_step + args.steps):
        batch = data.batch(i)
        mon.start()
        params, opt, metrics = step_fn(params, opt, batch)
        last_loss = float(metrics["loss"])   # waits for the step's kernels
        timing = mon.stop()
        losses[i + 1] = last_loss
        c.log_metrics(i + 1, {**metrics, "step_seconds":
                              timing["step_seconds"],
                              "straggler_flag": timing["flagged"]})
        if timing["tripped"]:
            print(f"[train] straggler trip at step {i+1}: checkpointing for "
                  "drain/replace")
            store.save(i + 1, {"params": params, "opt": opt}, blocking=True)
        elif (i + 1) % args.ckpt_every == 0:
            store.save(i + 1, {"params": params, "opt": opt})
        if (i + 1) % 10 == 0 or i == start_step:
            print(f"[train] step {i+1} loss={last_loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"t={timing['step_seconds']*1e3:.0f}ms")
    store.wait()
    store.save(start_step + args.steps, {"params": params, "opt": opt},
               blocking=True)
    print(f"[train] done at step {start_step + args.steps}; "
          f"overlay={c.overlay}")
    return {"final_loss": last_loss, "overlay": str(c.overlay),
            "steps": start_step + args.steps, "start_step": start_step,
            "losses": losses}


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
