"""Public entry point for flash attention, forward and backward.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain versions (``ref.py``); a CUDA tensor launches the hand-written
kernels of ``repro_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` or raises. There is no fallback between the
two. Which kernel runs is decided by the dtype alone:

- bfloat16: the tensor-core kernel (``mma.sync`` m16n8k16, FlashAttention-2
  schedule, 64-row query tiles, KV tiles of 64 rows, 32 at d 256);
- float32: the FMA kernel (tensor cores would mean TF32, outside the
  float32 tolerance).

Both take head dims ``HEAD_DIMS``. ``flash_attention`` is a
``torch.autograd.Function``. When an input needs a grad, its forward also
returns each row's log-sum-exp L (the kernel writes it beside the output;
on the CPU ``flash_attention_lse_ref``'s, from the same pass over the
scores as the output) and saves q, k, v, out and L; its
backward computes the grads from them: on a card the kernels of
``flash_attention_bwd.cu`` (D = rowsum(dO O), dK/dV, dQ; bf16 on the
tensor cores, float32 on FMA), on the CPU the dense float32
``flash_attention_bwd_ref``. The JAX package's ``custom_vjp`` instead
takes the vjp of its plain version (``_bwd_vjp``); the gradient is the
same function.

``launches`` counts forward kernel launches and ``bwd_launches`` the
backward's (one a backward call; CPU calls count in neither), so a run
can show that its prefill or training path went through the kernels;
under ``torch.utils.checkpoint`` the recomputed forward launches again.

Inside a ``core.trace.Counter`` the forward adds ``cost()`` there under
``flash_attention_fwd`` and the backward ``cost_bwd()`` under
``flash_attention_bwd``, on any device, and on a ``meta`` tensor each
returns empty results of the kernel's shapes (a traced step: the dry
run). Outside one a ``meta`` tensor raises like any device without a
kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (DTYPE_CODES, active, device_sms,
                                         dtype_code, raise_on_error, require,
                                         stream_ptr)
from repro_torch.kernels.flash_attention.ref import (_out_lse_ref,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref)

HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # the kernels' compiled head dims

launches = 0
bwd_launches = 0
_bound: set[str] = set()


def _lib(name: str = "flash_attention_fwd"):
    lib = _build.load(name)
    if name not in _bound:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_attention_fwd":
            lib.flash_attention_fwd_launch.argtypes = [
                i, p, p, p, p, p,           # dtype, q, k, v, o, lse
                i, i, i, i, i, i, i, i,     # B, Hq, Hkv, Sq, Sk, d, causal, window
                f, p]                       # scale, stream
        else:
            lib.flash_attention_bwd_launch.argtypes = [
                i, p, p, p, p, p,           # dtype, q, k, v, o, dO
                p, p, p,                    # lse, delta, part
                p, p, p,                    # dq, dk, dv
                i, i, i, i, i, i, i, i, i,  # B, Hq, Hkv, Sq, Sk, d, causal,
                f, p]                       # window, splits; scale, stream
            lib.flash_attention_bwd_key_block.argtypes = [i]
            lib.flash_attention_bwd_key_block.restype = i
        getattr(lib, f"{name}_launch").restype = i
        getattr(lib, f"{name}_error_string").argtypes = [i]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        _bound.add(name)
    return lib


def _check(tensors, q, what):
    """Device, contiguity, rank and dtype of every named tensor against
    q's; returns the dtype code."""
    for name, t in tensors:
        require(t.is_cuda and t.device == q.device,
                f"{what}: {name} must be on {q.device}, got {t.device}")
        require(t.is_contiguous(), f"{what}: {name} must be contiguous")
        require(t.dim() == 4, f"{what}: {name} must be 4-D")
    code = dtype_code(q, what)
    require(all(t.dtype == q.dtype for _, t in tensors),
            f"{what}: {', '.join(n for n, _ in tensors)} must share a dtype")
    return code


def _check_shapes(q, k, v, what):
    B, Hq, Sq, d = q.shape
    Hkv = k.shape[1]
    require(tuple(v.shape) == tuple(k.shape) and k.shape[0] == B
            and k.shape[3] == d,
            f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} disagree")
    require(Hkv > 0 and Hq % Hkv == 0,
            f"{what}: Hq={Hq} is not a multiple of Hkv={Hkv}")
    require(d in HEAD_DIMS, f"{what}: head dim {d} not in {HEAD_DIMS}")
    require(B * Hq <= 65535, f"{what}: B*Hq exceeds the grid")


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, scale: float | None = None,
                             lse: bool = False):
    """Launch the CUDA kernel. q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d),
    contiguous, on one CUDA device, one float32 or bfloat16 dtype. Returns
    out, or with ``lse`` (out, L): L float32 (B, Hq, Sq), each row's
    log-sum-exp (out is the same bits either way)."""
    global launches
    code = _check((("q", q), ("k", k), ("v", v)), q, "flash_attention")
    _check_shapes(q, k, v, "flash_attention")
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        require((q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0,
                "flash_attention: the bfloat16 kernel's 16-byte loads need "
                "16-byte aligned q, k and v")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    L = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
         if lse else None)
    if B == 0 or Sq == 0 or Hq == 0:
        return (out, L) if lse else out
    require(Sk > 0, "flash_attention: no keys")
    lib = _lib()
    rc = lib.flash_attention_fwd_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        L.data_ptr() if lse else None, B, Hq, Hkv, Sq, Sk, d,
        int(bool(causal)), int(window), float(scale), stream_ptr(q.device))
    raise_on_error(rc, lib, "flash_attention_fwd_error_string",
                   "flash_attention")
    launches += 1
    return (out, L) if lse else out


def bwd_key_block(dtype: torch.dtype) -> int:
    """Keys a block of the backward's dK/dV kernel for ``dtype``, as
    ``flash_attention_bwd.cu`` compiles it (builds the library)."""
    return _lib("flash_attention_bwd").flash_attention_bwd_key_block(
        DTYPE_CODES[dtype])


def group_splits(B: int, Hkv: int, Sk: int, g: int, key_block: int,
                 sms: int) -> int:
    """Parts of each GQA group the backward's dK/dV grid runs apart: 1
    when its (b, kv head, key block) blocks already fill the card's
    ``sms``, else the smallest divisor of ``g`` that does (``g`` itself at
    most). The parts' float32 partials are summed in order afterwards."""
    blocks = B * Hkv * -(-Sk // key_block)
    for n in range(1, g + 1):
        if g % n == 0 and blocks * n >= sms:
            return n
    return g


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             scale: float | None = None):
    """Launch the backward kernels. q, out, dout: (B, Hq, Sq, d); k, v: (B,
    Hkv, Sk, d), one float32 or bfloat16 dtype; lse: float32 (B, Hq, Sq),
    the forward's L; all contiguous on one CUDA device. Returns (dq, dk,
    dv), counted once in ``bwd_launches``."""
    global bwd_launches
    what = "flash_attention_bwd"
    code = _check((("q", q), ("k", k), ("v", v), ("out", out),
                   ("dout", dout)), q, what)
    _check_shapes(q, k, v, what)
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    require(tuple(out.shape) == tuple(q.shape)
            and tuple(dout.shape) == tuple(q.shape),
            f"{what}: out {tuple(out.shape)} and dout {tuple(dout.shape)} "
            f"must be q's shape {tuple(q.shape)}")
    require(lse.is_cuda and lse.device == q.device
            and lse.dtype == torch.float32 and lse.is_contiguous()
            and tuple(lse.shape) == (B, Hq, Sq),
            f"{what}: lse must be contiguous float32 {(B, Hq, Sq)} on "
            f"{q.device}")
    if q.dtype == torch.bfloat16:
        require((q.data_ptr() | k.data_ptr() | v.data_ptr() | out.data_ptr()
                 | dout.data_ptr()) % 16 == 0,
                f"{what}: the bfloat16 kernels' 16-byte loads need 16-byte "
                "aligned q, k, v, out and dout")
    if scale is None:
        scale = d ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0 or Hq == 0:
        return dq, dk.zero_(), dv.zero_()
    require(Sk > 0, f"{what}: no keys")
    lib = _lib("flash_attention_bwd")
    splits = group_splits(B, Hkv, Sk, Hq // Hkv,
                          lib.flash_attention_bwd_key_block(code),
                          device_sms(q.device))
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((splits, 2, *k.shape), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    rc = lib.flash_attention_bwd_launch(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        part.data_ptr() if part is not None else None, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, d,
        int(bool(causal)), int(window), splits, float(scale),
        stream_ptr(q.device))
    raise_on_error(rc, lib, "flash_attention_bwd_error_string", what)
    bwd_launches += 1
    return dq, dk, dv


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


def cost_bwd(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, d: int,
             isz: int, causal: bool = True,
             window: int = 0) -> tuple[float, int]:
    """(FLOPs, bytes) of one backward: q, k, v, out and dout read and dq,
    dk and dv written once (``isz`` bytes an element), L read and D
    written in float32; 10 flops a (q, k) pair inside the causal window
    per head dim (five products: S, dP, dV, dK, dQ)."""
    nbytes = (B * (4 * Hq * Sq + 4 * Hkv * Sk) * d * isz
              + 2 * B * Hq * Sq * 4)
    return 10.0 * B * Hq * _pairs(Sq, Sk, causal, window) * d, nbytes


def _forward(q, k, v, causal, window, scale, lse=False):
    """out, or with ``lse`` (out, L), through the counter when one is
    active."""
    counter = active()
    if counter is None:
        return _run(q, k, v, causal, window, scale, lse)
    (B, Hq, Sq, d), (Hkv, Sk) = q.shape, k.shape[1:3]
    with counter.kernel("flash_attention_fwd", *cost(
            B, Hq, Hkv, Sq, Sk, d, q.element_size(), causal, window)):
        if q.is_meta:
            out = torch.empty_like(q)
            return (out, q.new_empty((B, Hq, Sq), dtype=torch.float32)
                    ) if lse else out
        return _run(q, k, v, causal, window, scale, lse)


def _run(q, k, v, causal, window, scale, lse=False):
    if q.device.type == "cpu":
        if lse:
            return _out_lse_ref(q, k, v, causal, window, scale)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_fwd_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale, lse=lse)


def _backward(q, k, v, out, lse, dout, causal, window, scale):
    """(dq, dk, dv), through the counter when one is active."""
    counter = active()
    if counter is None:
        return _run_bwd(q, k, v, out, lse, dout, causal, window, scale)
    (B, Hq, Sq, d), (Hkv, Sk) = q.shape, k.shape[1:3]
    with counter.kernel("flash_attention_bwd", *cost_bwd(
            B, Hq, Hkv, Sq, Sk, d, q.element_size(), causal, window)):
        if q.is_meta:
            return torch.empty_like(q), torch.empty_like(k), \
                torch.empty_like(v)
        return _run_bwd(q, k, v, out, lse, dout, causal, window, scale)


def _run_bwd(q, k, v, out, lse, dout, causal, window, scale):
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no backward kernel for device "
                         f"{q.device}")
    return flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal,
                                    window=window, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (or, on the CPU, the plain version), with each
    row's L when an input needs a grad. Backward: the backward kernels
    from the saved q, k, v, out and L (on the CPU the dense plain
    version), the gradient the JAX package's ``_bwd_vjp`` takes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.args = (causal, window, scale)
        if not any(ctx.needs_input_grad[:3]):
            return _forward(q, k, v, causal, window, scale)
        out, lse = _forward(q, k, v, causal, window, scale, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_backward(q, k, v, out, lse, g.contiguous(), *ctx.args),
                None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k/v: (B, Hkv, Sk, d) -> (B, Hq, Sq, d), causal
    with the Sk - Sq offset. Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)
