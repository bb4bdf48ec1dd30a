"""Public entry point for the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain sequential version (``ref.py``); a CUDA tensor launches the
hand-written kernel ``repro_torch/csrc/rglru_scan.cu`` or raises. There is
no fallback between the two. Forward only, as serving needs.

``launches`` counts kernel launches (CPU calls do not count), so a run can
show that its prefill path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import raise_on_error, require, stream_ptr
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

THREADS = 128          # channels per block (the kernel's block size)
BLOCKS_PER_SM = 4      # blocks the time split aims to give each SM
MIN_STEPS = 32         # shortest time chunk one thread walks

launches = 0
_bound = False


def _lib():
    global _bound
    lib = _build.load("rglru_scan")
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_launch.argtypes = [
            p, p, p, p, p,                  # a, b, h, chunk prod, chunk end
            i, i, i, i, p]                  # B, S, R, steps per chunk, stream
        lib.rglru_scan_launch.restype = i
        lib.rglru_scan_error_string.argtypes = [i]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def time_chunk(B: int, S: int, R: int, device: torch.device) -> int:
    """Steps per time chunk: short enough that B * ceil(R/128) * n_chunks
    reaches about BLOCKS_PER_SM blocks for each SM of ``device``, never
    under MIN_STEPS steps."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_chunk = B * math.ceil(R / THREADS)
    want = max(1, math.ceil(BLOCKS_PER_SM * sms / max(1, per_chunk)))
    return max(MIN_STEPS, math.ceil(S / want))


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. a, b: (B, S, R) float32, contiguous, on one
    CUDA device; h0 = 0. Each thread walks a time chunk of ``time_chunk``
    steps; the chunks' carries are joined through a first pass over
    per-chunk summaries."""
    global launches
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
    T = time_chunk(B, S, R, a.device)
    nT = -(-S // T)
    require(B <= 65535 and nT <= 65535, "rglru_scan: B or chunks exceed "
            "the grid")
    scratch = None
    if nT > 1:
        scratch = torch.empty((2, B, nT, R), dtype=torch.float32,
                              device=a.device)
    rc = lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), h.data_ptr(),
        scratch[0].data_ptr() if scratch is not None else None,
        scratch[1].data_ptr() if scratch is not None else None,
        B, S, R, T, stream_ptr(a.device))
    raise_on_error(rc, lib, "rglru_scan_error_string", "rglru_scan")
    launches += 1
    return h


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1, h0 = 0. a, b: (B, S, R) f32."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    return rglru_scan_cuda(a, b)
