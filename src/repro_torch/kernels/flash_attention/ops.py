"""Public entry point for the flash-attention forward.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain version (``ref.py``); a CUDA tensor launches a hand-written kernel of
``repro_torch/csrc/flash_attention_fwd.cu`` or raises. There is no fallback
between the two. Which kernel runs is decided by the dtype alone:

- bfloat16: the tensor-core kernel (``mma.sync`` m16n8k16, FlashAttention-2
  schedule, 64-row query tiles, KV tiles of 64 rows, 32 at d 256);
- float32: the FMA kernel (tensor cores would mean TF32, outside the
  float32 tolerance).

Both take head dims ``HEAD_DIMS``. ``flash_attention`` is a
``torch.autograd.Function``: its backward recomputes the plain version on
the saved inputs and returns that version's vjp, as the JAX package's
``custom_vjp`` does (it has no backward kernel either).

``launches`` counts forward kernel launches (CPU calls do not count), so a
run can show that its prefill or training path went through the kernel;
under ``torch.utils.checkpoint`` the recomputed forward launches again.

Inside a ``core.trace.Counter`` the forward adds ``cost()`` there, on
any device, and on a ``meta`` tensor returns an empty output of the
kernel's shape (a traced step: the dry run). Outside one a ``meta``
tensor raises like any device without a kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (active, dtype_code, raise_on_error,
                                         require, stream_ptr)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # the kernels' compiled head dims

launches = 0
_bound = False


def _lib():
    global _bound
    lib = _build.load("flash_attention_fwd")
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd_launch.argtypes = [
            i, p, p, p, p,                  # dtype, q, k, v, o
            i, i, i, i, i, i, i, i,         # B, Hq, Hkv, Sq, Sk, d, causal, window
            ctypes.c_float, p]              # scale, stream
        lib.flash_attention_fwd_launch.restype = i
        lib.flash_attention_fwd_error_string.argtypes = [i]
        lib.flash_attention_fwd_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0,
                             scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d),
    contiguous, on one CUDA device, one float32 or bfloat16 dtype."""
    global launches
    B, Hq, Sq, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.is_cuda and t.device == q.device,
                f"flash_attention: {name} must be on {q.device}, "
                f"got {t.device}")
        require(t.is_contiguous(), f"flash_attention: {name} must be "
                "contiguous")
        require(t.dim() == 4, f"flash_attention: {name} must be 4-D")
    code = dtype_code(q, "flash_attention")
    require(k.dtype == q.dtype and v.dtype == q.dtype,
            "flash_attention: q, k and v must share a dtype")
    Hkv, Sk = k.shape[1], k.shape[2]
    require(tuple(v.shape) == tuple(k.shape) and k.shape[0] == B
            and k.shape[3] == d,
            f"flash_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    require(Hkv > 0 and Hq % Hkv == 0,
            f"flash_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    require(d in HEAD_DIMS, f"flash_attention: head dim {d} not in "
            f"{HEAD_DIMS}")
    require(B * Hq <= 65535, "flash_attention: B*Hq exceeds the grid")
    if q.dtype == torch.bfloat16:
        require((q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0,
                "flash_attention: the bfloat16 kernel's 16-byte loads need "
                "16-byte aligned q, k and v")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if B == 0 or Sq == 0 or Hq == 0:
        return out
    require(Sk > 0, "flash_attention: no keys")
    lib = _lib()
    rc = lib.flash_attention_fwd_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Sq, Sk, d, int(bool(causal)), int(window), float(scale),
        stream_ptr(q.device))
    raise_on_error(rc, lib, "flash_attention_fwd_error_string",
                   "flash_attention")
    launches += 1
    return out


@lru_cache(maxsize=256)
def _pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head attends: inside the causal window, with
    the Sk - Sq offset."""
    if not causal:
        return Sq * Sk
    off = Sk - Sq
    return sum(min(Sk, i + off + 1)
               - (max(0, i + off - window + 1) if window else 0)
               for i in range(Sq))


def cost(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, d: int, isz: int,
         causal: bool = True, window: int = 0) -> tuple[float, int]:
    """(FLOPs, bytes) of one forward: q, k, v read and out written once
    (``isz`` bytes an element), and 4 flops a (q, k) pair inside the
    causal window per head dim."""
    nbytes = B * (2 * Hq * Sq + 2 * Hkv * Sk) * d * isz
    return 4.0 * B * Hq * _pairs(Sq, Sk, causal, window) * d, nbytes


def _forward(q, k, v, causal, window, scale):
    counter = active()
    if counter is None:
        return _run(q, k, v, causal, window, scale)
    (B, Hq, Sq, d), (Hkv, Sk) = q.shape, k.shape[1:3]
    with counter.kernel("flash_attention_fwd", *cost(
            B, Hq, Hkv, Sq, Sk, d, q.element_size(), causal, window)):
        if q.is_meta:
            return torch.empty_like(q)
        return _run(q, k, v, causal, window, scale)


def _run(q, k, v, causal, window, scale):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_fwd_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (or, on the CPU, the plain version). Backward:
    the vjp of ``flash_attention_ref`` recomputed on the saved q, k, v
    (``repro.kernels.flash_attention.ops._bwd_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        return _forward(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.args
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_ref(*inputs, causal=causal, window=window,
                                      scale=scale)
        return (*torch.autograd.grad(out, inputs, g), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d) -> (B, Hq, Sq, d), causal
    with the Sk - Sq offset. Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)
