"""Public entry point for the flash-attention forward.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain version (``ref.py``); a CUDA tensor launches the hand-written kernel
``repro_torch/csrc/flash_attention_fwd.cu`` or raises. There is no fallback
between the two. Forward only: the backward and its
``torch.autograd.Function`` come with the training slice.

``launches`` counts kernel launches (CPU calls do not count), so a run can
show that its prefill path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (dtype_code, raise_on_error, require,
                                         stream_ptr)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernel's compiled tile shapes

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d) -> (B, Hq, Sq, d), causal
    with the Sk - Sq offset."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_fwd_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale)
