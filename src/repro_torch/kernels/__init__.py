"""Hand-written CUDA kernels for Hopper, one package per TPU kernel ported.

Each package holds ``ref.py`` (the plain PyTorch version) and ``ops.py``
(the public wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel built from ``repro_torch/csrc`` or raises)."""
