"""Quickstart: the paper's §3.2 'docker run' experience, end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--platform cpu]

Builds an image from an Imagefile, pushes it to a local registry with a
tag, runs a container on THIS machine (the laptop platform), takes a few
training steps, checkpoints, kills the container, and resumes in a fresh
one -- the whole portable-environment story at smoke scale.

PyTorch port of ``examples/quickstart.py``: the container's train step is
called directly, updating params and optimizer state in place
(``train_step_fn(donate=True)``, the JAX example's
``donate_argnums=(0, 1)``), on batches moved to the container's device.
"""

import argparse
import tempfile

import torch

from repro_torch.checkpoint.elastic import reshard_restore
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.runtime import Runtime
from repro_torch.data.pipeline import DataConfig, SyntheticLM

IMAGEFILE = """
# FEniCS-style stable image: tiny llama for the laptop platform
FROM scratch
ARCH llama3.2-3b-smoke
SHAPE train_4k seq_len=64 global_batch=8
MESH local
PRECISION params=float32 compute=float32
COLLECTIVES generic
SET optimizer={"lr":0.005,"warmup_steps":5,"total_steps":200}
LABEL tier=stable maintainer=stevedore
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the host CPU (default: the card)")
    ap.add_argument("--root", default=None,
                    help="runtime root (default: a new temporary dir)")
    args = ap.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="stevedore-")
    rt = Runtime(root)

    print("== build & push (quay.io analog) ==")
    image = rt.build(IMAGEFILE, tag="stable")
    for digest, kind, summary in image.history():
        print(f"  {digest} {kind:12s} {summary}")
    print(f"image: {image.short_digest}  tags: {rt.registry.tags()}")

    print("\n== docker run stable ==")
    c = rt.run("stable", platform=args.platform)
    params = c.init_params(seed=0)
    opt = c.init_opt_state(params)
    step = c.train_step_fn(donate=True)
    data = SyntheticLM(DataConfig(vocab_size=c.arch.vocab_size, seq_len=64,
                                  global_batch=8, seed=42))
    store = CheckpointStore(c.overlay / "ckpt")
    losses = []
    for i in range(10):
        batch = {k: torch.as_tensor(v, device=c.device)
                 for k, v in data.batch(i).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        print(f"  step {i+1:2d}  loss {losses[-1]:.4f}")
    store.save(10, {"params": params, "opt": opt}, blocking=True)
    print(f"checkpointed at step 10 -> {store.root}")

    print("\n== crash + resume in a fresh container ==")
    c2 = rt.run("stable", platform=args.platform)
    tmpl = {"params": c2.abstract_params(), "opt": c2.abstract_opt_state()}
    sh = {"params": c2.param_shardings(), "opt": c2.opt_state_shardings()}
    restored = reshard_restore(store, tmpl, sh)
    params2, opt2 = restored["params"], restored["opt"]
    step2 = c2.train_step_fn(donate=True)
    for i in range(10, 15):
        batch = {k: torch.as_tensor(v, device=c2.device)
                 for k, v in data.batch(i).items()}
        params2, opt2, m = step2(params2, opt2, batch)
        losses.append(float(m["loss"]))
        print(f"  step {i+1:2d}  loss {losses[-1]:.4f}  (resumed)")

    print(f"\ncontainers run from this image: "
          f"{[p['id'][:20] for p in rt.ps()]}")
    print("done.")
    return {"root": root, "image": image.digest, "losses": losses}


if __name__ == "__main__":
    main()
