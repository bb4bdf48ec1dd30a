"""Public entry point for the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain sequential version (``ref.py``); a CUDA tensor launches the
hand-written kernel ``repro_torch/csrc/rglru_scan.cu`` or raises. There is
no fallback between the two. ``rglru_scan`` is a
``torch.autograd.Function``: its backward is the JAX package's
(``repro.kernels.rglru_scan.ops._bwd_vjp``), the reverse recurrence
dh_t = g_t + a_{t+1} dh_{t+1} on the saved a, then da_t = dh_t h_{t-1}
and db_t = dh_t. The reverse recurrence goes through the forward's own
dispatch: on a card one launch of the same kernel with ``reverse`` (it
reads a one step ahead and runs time backwards, so no flipped copies are
made), on the CPU the plain scan on flipped copies, as the JAX package
runs it.

The kernel is one launch: a single-pass chained scan with decoupled
look-back over tiles of 32 channels x 8 ``steps`` time steps, a block a
tile. ``scan_plan`` picks ``steps`` from shapes and the SM count alone, and
the look-back composes a tile's carry in a fixed order, so a call's h is
the same bit for bit on every run. The kernel keeps its flags and
counters in a scratch buffer that lives with the (device, stream) it runs
on and that the kernel itself leaves ready for the next call;
``scratch_fills`` counts the zero-fills that allocating it costs (one per
stream, and one whenever a larger call grows it).

``launches`` counts forward kernel launches and ``bwd_launches`` the
backward's reverse ones (CPU calls count in neither), so a run can show
that its prefill or training path went through the kernel and every
forward launch count keeps its formula. Inside a ``core.trace.Counter``
the forward adds ``cost()`` there under ``rglru_scan`` and the reverse
scan the same cost under ``rglru_scan_bwd``, on any device, and on a
``meta`` tensor each returns an empty result (the dry run).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (active, device_index, device_sms,
                                         raise_on_error, require, stream_ptr)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

WARPS = 8                 # warps a block; each owns ``steps`` time steps
CHANNELS = 32             # channels a tile: one warp wide, 128-byte rows
STEPS = (1, 2, 4, 8, 16)  # steps per warp the kernel is compiled for
# scratch words: a header (ticket, done, epoch, unused), then per tile one
# 16-byte word (status and epoch, two floats, unused) for each channel
SCRATCH_HEADER = 4
SCRATCH_PER_TILE = 4 * CHANNELS

launches = 0
bwd_launches = 0
scratch_fills = 0
_bound = False
_scratch: dict[tuple[int, int], torch.Tensor] = {}


class ScanPlan(NamedTuple):
    steps: int      # time steps each warp owns
    T: int          # time steps a tile: WARPS * steps
    n_slabs: int    # 32-channel slabs: ceil(R / 32)
    n_chunks: int   # time chunks: ceil(S / T)
    n_tiles: int    # tiles, a block each: B * n_slabs * n_chunks


def _lib():
    global _bound
    lib = _build.load("rglru_scan")
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_launch.argtypes = [
            p, p, p, p, ctypes.c_longlong,  # a, b, h, scratch, its capacity
            i, i, i, i, i, p]               # B, S, R, steps, reverse, stream
        lib.rglru_scan_launch.restype = i
        lib.rglru_scan_error_string.argtypes = [i]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def scan_plan(B: int, S: int, R: int, sms: int) -> ScanPlan:
    """The tiles of one launch at (B, S, R) on a card of ``sms`` SMs, a
    block each. ``steps`` is the largest of STEPS whose tiles still number
    one for each SM, else the smallest: long tiles where there is work
    enough (fewer tiles to look back over), shorter ones where time is
    short, so the pod's 64-token prefills still reach every SM. Shapes
    only."""
    n_slabs = -(-R // CHANNELS)

    def n_tiles(st):
        return B * n_slabs * -(-S // (WARPS * st))

    fit = [st for st in STEPS if n_tiles(st) >= sms]
    steps = max(fit) if fit else STEPS[0]
    T = WARPS * steps
    return ScanPlan(steps, T, n_slabs, -(-S // T), n_tiles(steps))


def _scratch_for(device: torch.device, n_tiles: int) -> torch.Tensor:
    """The scratch of PyTorch's current stream on ``device``, holding at
    least ``n_tiles`` tiles (zero-filled when made or grown)."""
    global scratch_fills
    key = (device_index(device), stream_ptr(device))
    buf = _scratch.get(key)
    if buf is None or _capacity(buf) < n_tiles:
        cap = max(n_tiles, 2 * _capacity(buf) if buf is not None else 0)
        buf = torch.zeros(SCRATCH_HEADER + SCRATCH_PER_TILE * cap,
                          dtype=torch.int32, device=device)
        _scratch[key] = buf
        scratch_fills += 1
    return buf


def _capacity(buf: torch.Tensor) -> int:
    return (buf.numel() - SCRATCH_HEADER) // SCRATCH_PER_TILE


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel. a, b: (B, S, R) float32, contiguous, on one
    CUDA device; h0 = 0. With ``reverse`` the backward's adjoint
    recurrence, h_t = a_{t+1} h_{t+1} + b_t from the last step (a_S = 0),
    counted in ``bwd_launches``."""
    global launches, bwd_launches
    require(a.dim() == 3 and tuple(b.shape) == tuple(a.shape),
            f"rglru_scan: shapes a {tuple(a.shape)}, b {tuple(b.shape)} "
            "must be one (B, S, R)")
    for name, t in (("a", a), ("b", b)):
        require(t.is_cuda and t.device == a.device,
                f"rglru_scan: {name} must be on {a.device}, got {t.device}")
        require(t.is_contiguous(), f"rglru_scan: {name} must be contiguous")
        require(t.dtype == torch.float32,
                f"rglru_scan: {name} must be float32, got {t.dtype}")
    B, S, R = a.shape
    h = torch.empty_like(a)
    if B == 0 or S == 0 or R == 0:
        return h
    lib = _lib()
    plan = scan_plan(B, S, R, device_sms(a.device))
    require(plan.n_tiles < 2**31, "rglru_scan: tiles exceed the grid")
    scratch = _scratch_for(a.device, plan.n_tiles)
    rc = lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), scratch.data_ptr(),
        _capacity(scratch), B, S, R, plan.steps, int(bool(reverse)),
        stream_ptr(a.device))
    raise_on_error(rc, lib, "rglru_scan_error_string", "rglru_scan")
    if reverse:
        bwd_launches += 1
    else:
        launches += 1
    return h


def cost(B: int, S: int, R: int) -> tuple[float, int]:
    """(FLOPs, bytes) of one forward over (B, S, R) float32: a and b read
    and h written once, a multiply and an add a step and channel."""
    n = B * S * R
    return 2.0 * n, 3 * n * 4


def _forward(a: torch.Tensor, b: torch.Tensor,
             reverse: bool = False) -> torch.Tensor:
    counter = active()
    if counter is None:
        return _run(a, b, reverse)
    name = "rglru_scan_bwd" if reverse else "rglru_scan"
    with counter.kernel(name, *cost(*a.shape)):
        if a.is_meta:
            return torch.empty_like(a)
        return _run(a, b, reverse)


def _run(a: torch.Tensor, b: torch.Tensor,
         reverse: bool = False) -> torch.Tensor:
    if a.device.type == "cpu":
        if not reverse:
            return rglru_scan_ref(a, b)
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        return rglru_scan_ref(a_next.flip(1), b.flip(1)).flip(1)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    return rglru_scan_cuda(a, b, reverse)


class _RglruScan(torch.autograd.Function):
    """Forward: the kernel (or, on the CPU, the plain scan). Backward: the
    reverse recurrence of the JAX package's ``_bwd_vjp`` on the saved a
    and h, through the same dispatch (one reverse launch on a card)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        dh = _forward(a, g.contiguous(), reverse=True)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return dh * h_prev, dh


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1, h0 = 0. a, b: (B, S, R) f32.
    Differentiable in a and b."""
    return _RglruScan.apply(a, b)
