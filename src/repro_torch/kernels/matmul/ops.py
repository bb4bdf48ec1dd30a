"""Public entry point for the blocked matmul, with the per-platform block
table resolved when the call is made (the run-time binding of the fig5
tuned-kernel analog: the block shape is never baked into an image).

The platform comes from the tensor's device: a CUDA device of compute
capability 9.0 is ``h100``, a CPU tensor is ``cpu``, anything else raises.
A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
a hand-written kernel of ``repro_torch/csrc/matmul.cu`` or raises. There is
no fallback between the two.

Which kernel of that file runs, and at which tile, is ``kernel_choice(M,
N, K, dtype)``: a pure function of the shape and dtype, decided before the
launch and never after a failure, so one shape always gives the same bits.

- ``"wgmma"``: bfloat16 with K and N multiples of 8 (TMA needs 16-byte
  row strides): TMA-fed ``wgmma`` tiles of 128 x 256 or 128 x 128
  outputs.
- ``"fma"``: float32 (tensor cores would mean TF32, outside the float32
  tolerance) and bfloat16 shapes TMA cannot describe: FMA tiles of
  128 x 128 or 64 x 64 outputs.

The tile is the largest of the kernel's whose grid still has the kernel's
``MIN_BLOCKS`` blocks for the card's 132 SMs, else its smallest. Both
kernels handle ragged edges, so no shape shrinks its tile. ``blocks``
gives the shrunk blocks the JAX wrapper would pick for a shape, which the
kernels phase of ``chip_smoke.py`` reports beside each row.

``launches`` counts every kernel launch, wherever it comes from (CPU calls
and empty products do not count), so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (dtype_code, raise_on_error, require,
                                         stream_ptr)
from repro_torch.kernels.matmul.ref import matmul_ref

# csrc/matmul.cu's compiled tiles (BM, BN), largest first, per kernel
TILES = {"wgmma": ((128, 256), (128, 128)),
         "fma": ((128, 128), (64, 64))}
KERNEL_CODES = {"fma": 0, "wgmma": 1}
# the tensor-core kernel's k step (kTcBK in csrc/matmul.cu): 64 bfloat16,
# one 128-byte swizzle row
TC_BK = 64
# the fewest blocks a tile's grid may have to be chosen, per kernel. At
# llama3.2-3b's down product (M 512, K 8192, N 3072) on an H100 SXM
# (chip_smoke.py times every tile there): the tensor-core tiles of 128 x 128
# (96 blocks, one wave) beat 128 x 256 (48 blocks); the FMA tiles of
# 64 x 64 (384 blocks, about two an SM) beat 128 x 128 (96 blocks) by 13%
MIN_BLOCKS = {"wgmma": 96, "fma": 256}

# platform -> (block_m, block_n, block_k). h100: reported only, as the
# fig5 analog's per-platform binding (the CUDA path takes its tile from
# kernel_choice): the largest tensor-core tile, the one llama3.2-3b's
# gate/up product runs, 64 deep; cpu: the JAX package's interpret-mode
# entry (blocks do not change the plain version's result)
BLOCK_TABLE = {
    "h100": (*TILES["wgmma"][0], TC_BK),
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
            i, i, i, i,                     # dtype, kernel, bm, bn
            p, p, p,                        # a, b, c
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


def kernel_choice(M: int, N: int, K: int,
                  dtype: torch.dtype) -> tuple[str, int, int]:
    """(kernel, BM, BN) that ``matmul_cuda`` launches for an (M, K) @ (K, N)
    product in ``dtype``: "wgmma" for bfloat16 that TMA can describe (K > 0,
    K and N multiples of 8), else "fma"; the largest of its tiles whose
    grid has at least ``MIN_BLOCKS[kernel]`` blocks, else its smallest."""
    tma = dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0
    kernel = "wgmma" if tma else "fma"
    for bm, bn in TILES[kernel]:
        if -(-M // bm) * -(-N // bn) >= MIN_BLOCKS[kernel]:
            return kernel, bm, bn
    return (kernel, *TILES[kernel][-1])


def blocks(M: int, N: int, K: int, platform: str) -> tuple[int, int, int]:
    """The platform's blocks, each halved until it divides its dimension,
    then at least 8: what the JAX wrapper hands its kernel
    (``repro/kernels/matmul/ops.py:23-33``). The CUDA kernels do not take
    them: ``kernel_choice`` names their tile, and they handle ragged edges
    (TMA's zero fill, or the FMA kernel's masks)."""
    bm, bn, bk = BLOCK_TABLE[platform]
    while M % bm:
        bm //= 2
    while N % bn:
        bn //= 2
    while K % bk:
        bk //= 2
    return max(bm, 8), max(bn, 8), max(bk, 8)


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
            f"matmul: shapes a {tuple(a.shape)}, b {tuple(b.shape)} must be "
            "(M, K) and (K, N)")


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel and tile ``kernel_choice`` names. a: (M, K),
    b: (K, N), contiguous, on one CUDA device, one float32 or bfloat16
    dtype. Returns (M, N) in it."""
    _check_shapes(a, b)
    (M, K), N = a.shape, b.shape[1]
    return launch_tile(a, b, *kernel_choice(M, N, K, a.dtype))


def launch_tile(a: torch.Tensor, b: torch.Tensor, kernel: str, bm: int,
                bn: int) -> torch.Tensor:
    """One launch of ``kernel`` at tile (bm, bn), counted in ``launches``:
    ``matmul_cuda`` passes ``kernel_choice``'s; ``chip_smoke.py``'s kernels
    phase times the other tile through it (that phase is no main path, and
    the counts are reset before each main path)."""
    global launches
    _check_shapes(a, b)
    for name, t in (("a", a), ("b", b)):
        require(t.is_cuda and t.device == a.device,
                f"matmul: {name} must be on {a.device}, got {t.device}")
        require(t.is_contiguous(), f"matmul: {name} must be contiguous")
    require(b.dtype == a.dtype, f"matmul: b is {b.dtype}, a is {a.dtype}")
    code = dtype_code(a, "matmul")
    require((bm, bn) in TILES[kernel],
            f"matmul: {kernel} has no tile {(bm, bn)}")
    if kernel == "wgmma":
        require((a.data_ptr() | b.data_ptr()) % 16 == 0,
                "matmul: the tensor-core kernel's TMA loads need 16-byte "
                "aligned a and b")
    (M, K), N = a.shape, b.shape[1]
    lib = _lib()
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    rc = lib.matmul_launch(code, KERNEL_CODES[kernel], bm, bn, a.data_ptr(),
                           b.data_ptr(), out.data_ptr(), M, N, K,
                           stream_ptr(a.device))
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
