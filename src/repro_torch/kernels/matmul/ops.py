"""Public entry point for the blocked matmul, with the per-platform block
table resolved when the call is made (the run-time binding of the fig5
tuned-kernel analog: the block shape is never baked into an image).

The platform comes from the tensor's device: a CUDA device of compute
capability 9.0 is ``h100``, a CPU tensor is ``cpu``, anything else raises.
A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the hand-written kernel ``repro_torch/csrc/matmul.cu`` or raises. There is
no fallback between the two. The kernel is compiled for one tile, the
``h100`` entry, and masks ragged edges, so it takes every shape without
shrinking its blocks; ``blocks`` gives the shrunk blocks the JAX wrapper
would pick for a shape, which the kernels phase of ``chip_smoke.py``
reports beside each row.

``launches`` counts kernel launches (CPU calls do not count), so a run can
show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (dtype_code, raise_on_error, require,
                                         stream_ptr)
from repro_torch.kernels.matmul.ref import matmul_ref

# platform -> (block_m, block_n, block_k). h100: the kernel's one compiled
# tile (csrc/matmul.cu kBM, kBN, kBK), 128 x 128 outputs of 256 threads
# (8 x 8 accumulators each) staged 32 deep through 33 KB of shared memory;
# cpu: the JAX package's interpret-mode entry (blocks do not change the
# plain version's result)
BLOCK_TABLE = {
    "h100": (128, 128, 32),
    "cpu": (128, 128, 128),
}
# the device type each entry's blocks are for
PLATFORM_DEVICE = {"h100": "cuda", "cpu": "cpu"}

launches = 0
_bound = False


def _lib():
    global _bound
    lib = _build.load("matmul")
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.matmul_launch.argtypes = [
            i, p, p, p,                     # dtype, a, b, c
            i, i, i, p]                     # M, N, K, stream
        lib.matmul_launch.restype = i
        lib.matmul_error_string.argtypes = [i]
        lib.matmul_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def _platform(device: torch.device) -> str:
    """The block-table entry for ``device``, resolved at call time."""
    if device.type == "cpu":
        return "cpu"
    if device.type == "cuda" and \
            torch.cuda.get_device_capability(device) == (9, 0):
        return "h100"
    raise ValueError(f"matmul: no kernel for device {device}")


def blocks(M: int, N: int, K: int, platform: str) -> tuple[int, int, int]:
    """The platform's blocks, each halved until it divides its dimension,
    then at least 8: what the JAX wrapper hands its kernel
    (``repro/kernels/matmul/ops.py:23-33``). The CUDA kernel does not take
    them: it runs its one tile and masks the edges."""
    bm, bn, bk = BLOCK_TABLE[platform]
    while M % bm:
        bm //= 2
    while N % bn:
        bn //= 2
    while K % bk:
        bk //= 2
    return max(bm, 8), max(bn, 8), max(bk, 8)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on its ``h100`` tile. a: (M, K), b: (K, N),
    contiguous, on one CUDA device, one float32 or bfloat16 dtype. Returns
    (M, N) in it."""
    global launches
    require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
            f"matmul: shapes a {tuple(a.shape)}, b {tuple(b.shape)} must be "
            "(M, K) and (K, N)")
    for name, t in (("a", a), ("b", b)):
        require(t.is_cuda and t.device == a.device,
                f"matmul: {name} must be on {a.device}, got {t.device}")
        require(t.is_contiguous(), f"matmul: {name} must be contiguous")
    require(b.dtype == a.dtype, f"matmul: b is {b.dtype}, a is {a.dtype}")
    code = dtype_code(a, "matmul")
    (M, K), N = a.shape, b.shape[1]
    lib = _lib()
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    rc = lib.matmul_launch(code, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           M, N, K, stream_ptr(a.device))
    raise_on_error(rc, lib, "matmul_error_string", "matmul")
    launches += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor,
           platform: str | None = None) -> torch.Tensor:
    """(M,K) @ (K,N), f32 accumulation, result in a.dtype. ``platform``
    names a block-table entry; None resolves it from ``a``'s device."""
    platform = platform or _platform(a.device)
    if platform not in BLOCK_TABLE:
        raise ValueError(f"matmul: unknown platform {platform!r}; expected "
                         f"one of {sorted(BLOCK_TABLE)}")
    if PLATFORM_DEVICE[platform] != a.device.type:
        raise ValueError(f"matmul: the {platform!r} blocks are for "
                         f"{PLATFORM_DEVICE[platform]} tensors, got "
                         f"{a.device}")
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    return matmul_cuda(a, b)
