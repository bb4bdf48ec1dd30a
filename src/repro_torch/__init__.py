"""Stevedore on PyTorch: the container runtime and its serving path, ported
from the JAX package ``repro`` to PyTorch and hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

The port mirrors ``repro`` module for module (same file, class and function
names, same tensor layouts) so each module's counterpart is found at once:

  repro_torch.core          -- EnvImage, Imagefile, Registry, Container,
                               in-memory CompileCache, Runtime
  repro_torch.models        -- config schema, params, layers, attention and
                               the decoder-only transformer (dense blocks)
  repro_torch.dist          -- MESH layer -> one torch.device
  repro_torch.serve         -- slot / paged prefill and decode steps
  repro_torch.kernels       -- CUDA kernels (paged decode, flash forward)
                               with their plain PyTorch versions
  repro_torch.orchestrator  -- SlotEngine, ContinuousScheduler, Pod, PagePool

It imports torch and numpy, never jax and never ``repro``.
"""

__version__ = "1.0.0"
