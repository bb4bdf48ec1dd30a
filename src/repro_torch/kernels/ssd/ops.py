"""Public entry point for the chunked Mamba-2 SSD scan.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain chunked version (``ref._ssd_chunked``, the same algorithm,
exponents clipped the same way); a CUDA tensor launches the
hand-written kernel ``repro_torch/csrc/ssd.cu`` or raises. There is no
fallback between the two. ``ssd`` is a ``torch.autograd.Function``: its
backward recomputes ``_ssd_chunked`` on the saved inputs and returns its
vjp, as the JAX package's ``custom_vjp`` does (it has no backward kernel
either); a final state that nothing uses gets a zero gradient.

Unlike the TPU kernel, which returns y alone, both paths also return the
final state: the prefill hands it to decode.

The kernel runs as three device kernels (the chunks' own states and the
head-shared C.B^T, the serial pass over chunk states, the outputs; two
when S is one chunk, which needs no pass), and its products run on the
tensor cores in 3xTF32. It takes every shape the
wrapper accepts; ``p_tile(P)`` is the P slice it is compiled for, a pure
function of the shape decided before the launch.

``launches`` counts wrapper calls that launch the forward kernel (CPU
calls do not count), so a run can show that its prefill or training path
went through it. Inside a ``core.trace.Counter`` the forward adds
``cost()`` there, on any device, and on ``meta`` tensors returns empty
outputs (the dry run).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (active, raise_on_error, require,
                                         stream_ptr)
from repro_torch.kernels.ssd.ref import _ssd_chunked

MAX_CHUNK = 256        # the kernel's shared-memory arrays of one chunk
MAX_STATE = 128        # state rows N the kernel takes
P_TILES = (16, 32, 64, 128)   # compiled P slices (x columns a block owns)
SCORE_ALIGN = 32       # the score scratch's rows are padded to this

launches = 0
_bound = False


def _lib():
    global _bound
    lib = _build.load("ssd")
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_launch.argtypes = [
            p, p, p, p, p,                  # x, dt, A, B, C
            p, p,                           # y, final state
            p, p, p, p,                     # scratch: scores, cum, chunk
                                            # states, entering states
            i, i, i, i, i, i, i, p]         # b, S, H, P, N, chunk, pt, stream
        lib.ssd_launch.restype = i
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def p_tile(P: int) -> int:
    """The P slice the kernel runs for head dim P: the smallest compiled
    slice that covers P (one slice: each score tile is read once per
    chunk and head), else the widest (P > 128 takes several)."""
    return next((t for t in P_TILES if t >= P), P_TILES[-1])


def scratch_shapes(b: int, S: int, H: int, P: int, N: int,
                   chunk: int) -> dict[str, tuple[int, ...]]:
    """Float32 scratch of one launch: the chunks' C.B^T (rows padded to
    SCORE_ALIGN), their cumsums, their own states and the states entering
    them."""
    bc = b * (S // chunk)
    qp = -(-chunk // SCORE_ALIGN) * SCORE_ALIGN
    return {"scores": (bc, chunk, qp), "cum": (bc, H, chunk),
            "states": (bc, H, N, P), "prev": (bc, H, N, P)}


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Launch the CUDA kernel. x (b,S,H,P), dt (b,S,H), A (H,), B and C
    (b,S,N): float32, contiguous, on one CUDA device; S % chunk == 0,
    chunk <= 256, N <= 128, P a multiple of 16.
    Returns (y (b,S,H,P), final state (b,H,N,P)), both float32."""
    global launches
    b, S, H, P = x.shape
    N = B.shape[-1]
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        require(t.is_cuda and t.device == x.device,
                f"ssd: {name} must be on {x.device}, got {t.device}")
        require(t.is_contiguous(), f"ssd: {name} must be contiguous")
        require(t.dtype == torch.float32,
                f"ssd: {name} must be float32, got {t.dtype}")
    require(tuple(dt.shape) == (b, S, H) and tuple(A.shape) == (H,)
            and tuple(B.shape) == (b, S, N) and tuple(C.shape) == (b, S, N),
            f"ssd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)} "
            "disagree")
    require(0 < chunk <= MAX_CHUNK and S % chunk == 0,
            f"ssd: chunk {chunk} must divide S={S} and be at most "
            f"{MAX_CHUNK}")
    require(0 < N <= MAX_STATE, f"ssd: state size {N} exceeds {MAX_STATE}")
    require(P > 0 and P % 16 == 0,
            f"ssd: head dim {P} is not a multiple of 16")
    pt = p_tile(P)
    require(b * (S // chunk) <= 65535 and H * -(-P // pt) <= 65535,
            "ssd: b * S / chunk or H exceeds the grid")
    lib = _lib()
    y = torch.empty_like(x)
    state = torch.empty((b, H, N, P), dtype=torch.float32, device=x.device)
    if b == 0 or S == 0 or H == 0:
        return y, state.zero_()
    scratch = {k: torch.empty(v, dtype=torch.float32, device=x.device)
               for k, v in scratch_shapes(b, S, H, P, N, chunk).items()}
    rc = lib.ssd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch["scores"].data_ptr(),
        scratch["cum"].data_ptr(), scratch["states"].data_ptr(),
        scratch["prev"].data_ptr(), b, S, H, P, N, chunk, pt,
        stream_ptr(x.device))
    raise_on_error(rc, lib, "ssd_error_string", "ssd")
    launches += 1
    return y, state


def flops(b: int, S: int, H: int, P: int, N: int, Q: int) -> float:
    """Operations of the chunked SSD, products at or below the diagonal
    only: head-shared C.B^T, the causal intra-chunk product, the
    inter-chunk product and the state update (2 flops a multiply-add)."""
    tri = Q * (Q + 1) // 2
    per_chunk = 2.0 * (N * tri + H * (tri * P + 2 * Q * N * P))
    return b * (S // Q) * per_chunk


def cost(b: int, S: int, H: int, P: int, N: int,
         chunk: int) -> tuple[float, int]:
    """(FLOPs, bytes) of one forward in float32: x, dt, A, B and C read,
    y and the final state written once."""
    nbytes = 4 * (2 * b * S * H * P + b * S * H + H + 2 * b * S * N
                  + b * H * N * P)
    return flops(b, S, H, P, N, chunk), nbytes


def _forward(x, dt, A, B, C, chunk: int):
    counter = active()
    if counter is None:
        return _run(x, dt, A, B, C, chunk)
    (b, S, H, P), N = x.shape, B.shape[-1]
    with counter.kernel("ssd", *cost(b, S, H, P, N, chunk)):
        if x.is_meta:
            return (torch.empty_like(x),
                    x.new_empty((b, H, N, P), dtype=torch.float32))
        return _run(x, dt, A, B, C, chunk)


def _run(x, dt, A, B, C, chunk: int):
    if x.device.type == "cpu":
        require(chunk > 0 and x.shape[1] % chunk == 0,
                f"ssd: chunk {chunk} must divide S={x.shape[1]}")
        return _ssd_chunked(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    return ssd_cuda(x, dt, A, B, C, chunk)


class _Ssd(torch.autograd.Function):
    """Forward: the kernel (or, on the CPU, the plain chunked version).
    Backward: the vjp of ``_ssd_chunked`` recomputed on the saved inputs
    (``repro.kernels.ssd.ops._bwd_vjp``), for y and the final state."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, state = _ssd_chunked(*inputs, ctx.chunk)
        return (*torch.autograd.grad((y, state), inputs, (gy, gstate)),
                None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int):
    """Chunked SSD; shapes as ``ssd_ref``, S % chunk == 0.
    Returns (y (b,S,H,P), final state (b,H,N,P)), float32; differentiable
    in x, dt, A, B and C."""
    return _Ssd.apply(x, dt, A, B, C, chunk)
