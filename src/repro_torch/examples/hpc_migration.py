"""The paper's core demo, §3.3/Fig.1: laptop -> HPC migration with ONE image.

    PYTHONPATH=src python -m repro_torch.examples.hpc_migration [--platform cpu]

Same image, three "platforms":
  1. laptop (local 1-device): develop + debug, a few training steps;
  2. checkpoint travels with the overlay;
  3. "HPC" re-instantiation: the image's collectives layer is swapped
     generic -> host (the Cray-MPI move) WITHOUT touching arch/shape layers,
     and the elastic restore re-shards the checkpoint onto the new mesh.

On one card (or with ``--platform cpu``) the "HPC" platform is the same
single device (the point is the artifact flow + the layer-sharing
assertion); under torchrun each process would be one rank and nothing
else changes.

PyTorch port of ``examples/hpc_migration.py``: the container's train step
is called directly, updating params and optimizer state in place
(``train_step_fn(donate=True)``), on batches moved to the container's
device.
"""

import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.checkpoint.elastic import reshard_restore
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.image import ImageBuilder
from repro_torch.core.runtime import Runtime
from repro_torch.data.pipeline import DataConfig, SyntheticLM

IMAGEFILE_DEV = """
FROM scratch
ARCH llama3.2-3b-smoke
SHAPE train_4k seq_len=64 global_batch=8
MESH local
PRECISION params=float32 compute=float32
COLLECTIVES generic
SET optimizer={"lr":0.005,"warmup_steps":5,"total_steps":100}
LABEL tier=dev
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the host CPU (default: the card)")
    ap.add_argument("--root", default=None,
                    help="runtime root (default: a new temporary dir)")
    args = ap.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="stevedore-hpc-")
    rt = Runtime(root)
    losses = []

    # ---- laptop phase -----------------------------------------------------
    dev_img = rt.build(IMAGEFILE_DEV, tag="dev")
    c = rt.run("dev", platform=args.platform)
    print(f"[laptop] running {dev_img.short_digest} on platform "
          f"{c.platform} (abi={c.abi.describe()})")
    params = c.init_params(0)
    opt = c.init_opt_state(params)
    step = c.train_step_fn(donate=True)
    data = SyntheticLM(DataConfig(vocab_size=c.arch.vocab_size, seq_len=64,
                                  global_batch=8, seed=1))
    for i in range(5):
        batch = {k: torch.as_tensor(v, device=c.device)
                 for k, v in data.batch(i).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    print(f"[laptop] step 5 loss={losses[-1]:.4f}")
    store = CheckpointStore(Path(root) / "shared-ckpt")   # the $SCRATCH mount
    store.save(5, {"params": params, "opt": opt}, blocking=True)

    # ---- the ABI swap: derive the HPC image FROM the dev image -------------
    hpc_img = (ImageBuilder.from_image(dev_img)
               .collectives("host", zero1=True)
               .label(tier="hpc")
               .build())
    stats = rt.push(hpc_img, tag="hpc")
    print(f"[registry] pushed hpc image: {stats.layers_transferred} new "
          f"layers, {stats.layers_reused} reused (dedupe "
          f"{stats.dedupe_fraction:.0%}) -- the MPICH->Cray swap touched "
          "ONLY the collectives layer")

    # ---- HPC phase: same artifact, restored state, different ABI -----------
    c2 = rt.run("hpc", platform=args.platform)   # torchrun on a cluster
    print(f"[hpc] running {hpc_img.short_digest} on platform {c2.platform} "
          f"(abi={c2.abi.describe()})")
    tmpl = {"params": c2.abstract_params(), "opt": c2.abstract_opt_state()}
    sh = {"params": c2.param_shardings(), "opt": c2.opt_state_shardings()}
    restored = reshard_restore(store, tmpl, sh)
    params2, opt2 = restored["params"], restored["opt"]
    step2 = c2.train_step_fn(donate=True)
    for i in range(5, 10):
        batch = {k: torch.as_tensor(v, device=c2.device)
                 for k, v in data.batch(i).items()}
        params2, opt2, m = step2(params2, opt2, batch)
        losses.append(float(m["loss"]))
    print(f"[hpc] step 10 loss={losses[-1]:.4f} -- continued "
          "seamlessly under the host ABI")
    return {"root": root, "images": (dev_img.digest, hpc_img.digest),
            "layers_transferred": stats.layers_transferred,
            "layers_reused": stats.layers_reused, "losses": losses}


if __name__ == "__main__":
    main()
