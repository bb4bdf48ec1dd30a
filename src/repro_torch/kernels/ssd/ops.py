"""Public entry point for the chunked Mamba-2 SSD scan.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain chunked version (``ref._ssd_chunked``, the same algorithm,
exponents clipped the same way); a CUDA tensor launches the
hand-written kernel ``repro_torch/csrc/ssd.cu`` or raises. There is no
fallback between the two. ``ssd`` is a ``torch.autograd.Function``: its
backward is the vjp of the chunked version, the gradient the JAX
package's ``custom_vjp`` takes (which has no backward kernel). On a CUDA
tensor it launches the backward kernels of the same source
(``ssd_bwd_cuda``); on a CPU tensor it runs ``ref.ssd_bwd_ref``, the
same phases written out in PyTorch. A final state that nothing uses gets
a zero gradient.

Unlike the TPU kernel, which returns y alone, both paths also return the
final state: the prefill hands it to decode.

The forward runs as three device kernels (the chunks' own states and the
head-shared C.B^T, the serial pass over chunk states, the outputs; two
when S is one chunk, which needs no pass), and its products run on the
tensor cores in 3xTF32. It takes every shape the
wrapper accepts; ``p_tile(P)`` is the P slice it is compiled for, a pure
function of the shape decided before the launch. The backward takes the
same shapes; its head groups (``bwd_head_groups``) and its route
(``bwd_route``: TMA + wgmma product kernels at mamba2's P 64 and N 128
with a chunk a multiple of 64, the ``mma.sync`` kernels elsewhere) are
also functions of the shape alone.

``launches`` counts wrapper calls that launch the forward kernel and
``bwd_launches`` those that launch the backward kernels (CPU calls count
in neither), so a run can show that its prefill or training path went
through them. Inside a ``core.trace.Counter`` the forward adds ``cost()``
there and the backward ``cost_bwd()`` (as ``ssd_bwd``), on any device,
and on ``meta`` tensors both return empty outputs (the dry run).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (active, raise_on_error, require,
                                         stream_ptr)
from repro_torch.kernels.ssd.ref import _ssd_chunked, ssd_bwd_ref

MAX_CHUNK = 256        # the kernel's shared-memory arrays of one chunk
MAX_STATE = 128        # state rows N the kernel takes
P_TILES = (16, 32, 64, 128)   # compiled P slices (x columns a block owns)
SCORE_ALIGN = 32       # the score scratch's rows are padded to this

# the backward's blocks of the dP and the dB/dC kernels sum a group of
# heads each; groups are sized for a card that runs about this many of
# each kernel's blocks at once (two and three an SM on 132 SMs), and hold
# at least BWD_MIN_GROUP heads (each group's float32 parts are summed
# afterwards)
BWD_BLOCKS = (264, 396)
BWD_MIN_GROUP = 8

launches = 0
bwd_launches = 0
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
        lib.ssd_bwd_launch.argtypes = [
            p, p, p, p, p, p, p,            # x, dt, A, B, C, gy, gstate
            p, p, p, p, p,                  # dx, ddt, dA, dB, dC
            p,                              # the scratch pointers
            i, i, i, i, i, i, i, i, i, p]   # b, S, H, P, N, chunk, pt,
                                            # hg_dp, hg_dbc, stream
        lib.ssd_bwd_launch.restype = i
        lib.ssd_bwd_error_string.argtypes = [i]
        lib.ssd_bwd_error_string.restype = ctypes.c_char_p
        lib.ssd_bwd_route.argtypes = [i, i, i]
        lib.ssd_bwd_route.restype = i
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


def _check(what: str, chunk: int, x, dt, A, B, C, **more) -> int:
    """Raise on what the kernels do not take (``more``: further tensors
    checked as the inputs are); returns the P slice."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                    *more.items()):
        require(t.is_cuda and t.device == x.device,
                f"{what}: {name} must be on {x.device}, got {t.device}")
        require(t.is_contiguous(), f"{what}: {name} must be contiguous")
        require(t.dtype == torch.float32,
                f"{what}: {name} must be float32, got {t.dtype}")
    require(tuple(dt.shape) == (b, S, H) and tuple(A.shape) == (H,)
            and tuple(B.shape) == (b, S, N) and tuple(C.shape) == (b, S, N),
            f"{what}: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)} "
            "disagree")
    require(0 < chunk <= MAX_CHUNK and S % chunk == 0,
            f"{what}: chunk {chunk} must divide S={S} and be at most "
            f"{MAX_CHUNK}")
    require(0 < N <= MAX_STATE,
            f"{what}: state size {N} exceeds {MAX_STATE}")
    require(P > 0 and P % 16 == 0,
            f"{what}: head dim {P} is not a multiple of 16")
    pt = p_tile(P)
    require(b * (S // chunk) <= 65535 and H * -(-P // pt) <= 65535,
            f"{what}: b * S / chunk or H exceeds the grid")
    return pt


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Launch the CUDA kernel. x (b,S,H,P), dt (b,S,H), A (H,), B and C
    (b,S,N): float32, contiguous, on one CUDA device; S % chunk == 0,
    chunk <= 256, N <= 128, P a multiple of 16.
    Returns (y (b,S,H,P), final state (b,H,N,P)), both float32."""
    global launches
    b, S, H, P = x.shape
    N = B.shape[-1]
    pt = _check("ssd", chunk, x, dt, A, B, C)
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


BWD_ROUTES = ("mma.sync", "wgmma")


def bwd_route(P: int, N: int, chunk: int) -> str:
    """The kernels ``ssd_bwd_cuda`` runs for head dim P, state size N and
    ``chunk``, as ``csrc/ssd.cu``'s ``ssd_bwd_route`` names them: "wgmma"
    (TMA + wgmma product kernels: P 64, N 128, a chunk a multiple of 64,
    mamba2's widths) or "mma.sync" (the first version's kernels: every
    other shape). A pure function of the shape; it needs the built
    library."""
    return BWD_ROUTES[_lib().ssd_bwd_route(P, N, chunk)]


def bwd_head_groups(b: int, S: int, H: int, N: int,
                    chunk: int) -> tuple[int, int]:
    """Heads a block sums in the backward's dP kernel (one a 64 x 64 tile
    of a chunk at or below the diagonal) and in its dB/dC kernel (one a
    64-row, 64-column tile of dB or dC a chunk): the group size whose waves
    of the kernel's BWD_BLOCKS blocks times heads a block is least (the
    fewest groups on a tie), with groups of at least BWD_MIN_GROUP heads
    where H has that many."""
    bc, nt = b * (S // chunk), -(-chunk // 64)

    def size(blocks: int, at_once: int) -> int:
        def cost(sz: int) -> tuple[int, int]:
            groups = -(-H // sz)
            return -(-blocks * groups // at_once) * sz, groups
        return min(range(min(H, BWD_MIN_GROUP), H + 1), key=cost)
    return (size(bc * nt * (nt + 1) // 2, BWD_BLOCKS[0]),
            size(bc * 2 * nt * -(-N // 64), BWD_BLOCKS[1]))


def bwd_scratch_shapes(b: int, S: int, H: int, P: int, N: int,
                       chunk: int) -> dict[str, tuple[int, ...]]:
    """Float32 scratch of one backward launch, in the order
    ``ssd_bwd_launch`` takes it: the forward's (recomputed), the states'
    gradients lam, and the parts each fixed-order sum adds up."""
    bc, nt = b * (S // chunk), -(-chunk // 64)
    qp = -(-chunk // SCORE_ALIGN) * SCORE_ALIGN
    hg_dp, hg_dbc = bwd_head_groups(b, S, H, N, chunk)
    n_psl = -(-P // p_tile(P))
    return {**scratch_shapes(b, S, H, P, N, chunk),
            "lam": (bc, H, N, P),
            "dg_part": (bc, H, -(-(N * P // 4) // 256), 8),
            "dG_part": (-(-H // hg_dp), bc, chunk, qp),
            "dG": (bc, chunk, qp),
            "rsum": (bc, H, nt, chunk), "csum": (bc, H, nt, chunk),
            "dsum": (bc, H, nt, chunk), "sdiag": (bc, H, chunk),
            "dw_part": (bc, H, n_psl, chunk),
            "de_part": (bc, H, n_psl, chunk),
            "dbc_part": (-(-H // hg_dbc), 2, b * S, N),
            "dA_part": (bc, H)}


def ssd_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 gy: torch.Tensor, gstate: torch.Tensor | None = None):
    """Launch the backward kernels: the vjp of ``ssd_cuda``'s function.
    Inputs as ``ssd_cuda``; gy (b,S,H,P) the cotangent of y, gstate
    (b,H,N,P) that of the final state or None (no gradient reaches it),
    float32, contiguous, on x's device. Returns (dx, ddt, dA, dB, dC),
    float32, counted once in ``bwd_launches``."""
    global bwd_launches
    b, S, H, P = x.shape
    N = B.shape[-1]
    pt = _check("ssd_bwd", chunk, x, dt, A, B, C, gy=gy,
                **({} if gstate is None else {"gstate": gstate}))
    require(tuple(gy.shape) == tuple(x.shape)
            and (gstate is None or tuple(gstate.shape) == (b, H, N, P)),
            f"ssd_bwd: gy {tuple(gy.shape)} must be x's shape and gstate "
            f"{None if gstate is None else tuple(gstate.shape)} "
            f"{(b, H, N, P)}")
    lib = _lib()
    if b == 0 or S == 0 or H == 0:
        return tuple(torch.zeros_like(t) for t in (x, dt, A, B, C))
    grads = tuple(torch.empty_like(t) for t in (x, dt, A, B, C))
    hg_dp, hg_dbc = bwd_head_groups(b, S, H, N, chunk)
    scratch = [torch.empty(v, dtype=torch.float32, device=x.device)
               for v in bwd_scratch_shapes(b, S, H, P, N, chunk).values()]
    ptrs = (ctypes.c_void_p * len(scratch))(*(t.data_ptr() for t in scratch))
    ptrs = ctypes.cast(ptrs, ctypes.c_void_p)
    rc = lib.ssd_bwd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        gy.data_ptr(), None if gstate is None else gstate.data_ptr(),
        *(t.data_ptr() for t in grads), ptrs, b, S, H, P, N, chunk, pt,
        hg_dp, hg_dbc, stream_ptr(x.device))
    raise_on_error(rc, lib, "ssd_bwd_error_string", "ssd_bwd")
    bwd_launches += 1
    return grads


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


def cost_bwd(b: int, S: int, H: int, P: int, N: int,
             chunk: int) -> tuple[float, int]:
    """(FLOPs, bytes) of one backward in float32: x, dt, A, B, C and the
    cotangents of y and the final state read, their grads written once;
    each of the forward's products has two in the backward (one for each
    operand's grad), so twice the forward's operations."""
    nbytes = 4 * (3 * b * S * H * P + 2 * (b * S * H + H + 2 * b * S * N)
                  + b * H * N * P)
    return 2.0 * flops(b, S, H, P, N, chunk), nbytes


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


def _backward(x, dt, A, B, C, chunk: int, gy, gstate):
    """(dx, ddt, dA, dB, dC), through the counter when one is active."""
    counter = active()
    if counter is None:
        return _run_bwd(x, dt, A, B, C, chunk, gy, gstate)
    (b, S, H, P), N = x.shape, B.shape[-1]
    with counter.kernel("ssd_bwd", *cost_bwd(b, S, H, P, N, chunk)):
        if x.is_meta:
            return tuple(torch.empty_like(t) for t in (x, dt, A, B, C))
        return _run_bwd(x, dt, A, B, C, chunk, gy, gstate)


def _run_bwd(x, dt, A, B, C, chunk: int, gy, gstate):
    if x.device.type == "cpu":
        require(chunk > 0 and x.shape[1] % chunk == 0,
                f"ssd: chunk {chunk} must divide S={x.shape[1]}")
        return ssd_bwd_ref(x, dt, A, B, C, chunk, gy, gstate)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no backward kernel for device {x.device}")
    return ssd_bwd_cuda(x, dt, A, B, C, chunk, gy, gstate)


class _Ssd(torch.autograd.Function):
    """Forward: the kernel (or, on the CPU, the plain chunked version).
    Backward: the vjp of ``_ssd_chunked`` for y and the final state (the
    JAX package's ``_bwd_vjp``), from the saved inputs: the backward
    kernels on a card, ``ssd_bwd_ref`` on the CPU. A cotangent autograd
    leaves out (an unused output) is zero: the final state's is not read."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        x, dt, A, B, C = ctx.saved_tensors
        gy = torch.zeros_like(x) if gy is None else gy.contiguous()
        if gstate is not None:
            gstate = gstate.contiguous()
        return (*_backward(x, dt, A, B, C, ctx.chunk, gy, gstate), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int):
    """Chunked SSD; shapes as ``ssd_ref``, S % chunk == 0.
    Returns (y (b,S,H,P), final state (b,H,N,P)), float32; differentiable
    in x, dt, A, B and C."""
    return _Ssd.apply(x, dt, A, B, C, chunk)
