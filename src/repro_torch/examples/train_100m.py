"""End-to-end driver: train a ~100M-param llama3.2-shape model for a few
hundred steps on the local platform (the assignment's (b) e2e requirement).

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300] \
        [--platform cpu]

~100M config: 8 layers, d_model 512, 8 heads (kv 4), d_ff 1536, vocab 32000
-> 0.10B params. Uses the real production path: Imagefile -> registry ->
container -> train step with checkpointing + straggler monitor, via the
same launch/train.py driver the cluster would use.

PyTorch port of ``examples/train_100m.py``: the same Imagefile through the
port's ``launch/train.py`` driver.
"""

import argparse
import tempfile
from pathlib import Path

from repro_torch.launch.train import main as train_main

IMAGEFILE = """
FROM scratch
ARCH llama3.2-3b n_layers=8 d_model=512 n_heads=8 n_kv_heads=4 head_dim=64 d_ff=1536 vocab_size=32000
SHAPE train_4k seq_len=128 global_batch=4
MESH local
PRECISION params=float32 compute=bfloat16
COLLECTIVES generic
SET optimizer={"lr":0.0003,"warmup_steps":50,"total_steps":1000} remat=none
LABEL tier=example purpose=train-100m
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the host CPU (default: the card)")
    ap.add_argument("--root", default=None,
                    help="runtime root (default: a new temporary dir)")
    args = ap.parse_args(argv)
    tmp = args.root or tempfile.mkdtemp(prefix="stevedore-100m-")
    imagefile = Path(tmp) / "Imagefile"
    imagefile.parent.mkdir(parents=True, exist_ok=True)
    imagefile.write_text(IMAGEFILE)
    platform = ["--platform", args.platform] if args.platform else []
    result = train_main([
        "--image", str(imagefile),
        "--root", tmp,
        "--steps", str(args.steps),
        "--ckpt-every", "50",
        *platform,
    ])
    print(f"final loss after {result['steps']} steps: "
          f"{result['final_loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
