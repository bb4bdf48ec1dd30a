"""Serve a small model with batched requests through the container runtime.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--platform cpu]

PyTorch port of ``examples/serve_batched.py``: the same Imagefile and
request mix through the port's ``launch/serve.py`` driver.
"""

import argparse
import tempfile
from pathlib import Path

from repro_torch.launch.serve import main as serve_main

IMAGEFILE = """
FROM scratch
ARCH llama3.2-3b n_layers=6 d_model=384 n_heads=6 n_kv_heads=2 head_dim=64 d_ff=1024 vocab_size=32000
SHAPE decode_32k seq_len=256 global_batch=8
MESH local
PRECISION params=float32 compute=bfloat16
COLLECTIVES generic
LABEL tier=example purpose=serving
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the host CPU (default: the card)")
    ap.add_argument("--root", default=None,
                    help="runtime root (default: a new temporary dir)")
    args = ap.parse_args(argv)
    tmp = args.root or tempfile.mkdtemp(prefix="stevedore-serve-")
    imagefile = Path(tmp) / "Imagefile"
    imagefile.parent.mkdir(parents=True, exist_ok=True)
    imagefile.write_text(IMAGEFILE)
    platform = ["--platform", args.platform] if args.platform else []
    return serve_main([
        "--image", str(imagefile),
        "--root", tmp,
        "--requests", "8",
        "--prompt-len", "64",
        "--gen", "32",
        *platform,
    ])


if __name__ == "__main__":
    main()
