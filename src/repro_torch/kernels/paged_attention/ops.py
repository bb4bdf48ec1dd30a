"""Public entry point for paged decode attention.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain version (``ref.py``); a CUDA tensor launches the hand-written kernel
``repro_torch/csrc/paged_attention.cu`` or raises. There is no fallback
between the two.

``launches`` counts kernel launches (CPU calls do not count), so a run can
show that its decode path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (dtype_code, raise_on_error, require,
                                         stream_ptr)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

launches = 0
_bound = False
_sm_count: dict[int, int] = {}


def _lib():
    global _bound
    lib = _build.load("paged_attention")
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            i, p, p, p, p, p, p,            # dtype, q, k, v, table, lengths, out
            p, p,                           # part_acc, part_ml (split scratch)
            i, i, i, i, i, i, i, i,         # B, Hq, n_kv, n_pages, ps, hd, mp, window
            ctypes.c_float, i, p]           # scale, n_split, stream
        lib.paged_attention_launch.restype = i
        lib.paged_attention_num_splits.argtypes = [i, i, i, i, i, i]
        lib.paged_attention_num_splits.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, *, window: int = 0,
                         scale: float | None = None,
                         n_split: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. Every tensor must be contiguous and on one
    CUDA device; q/k/v share a float32 or bfloat16 dtype (16-byte aligned);
    table and lengths are int32; the head dim is a power of two in
    [16, 256]. ``n_split`` cuts each slot's live pages into that many
    ranges merged by a second kernel; None picks enough for about four
    blocks per SM, 1 runs the single-pass kernel alone."""
    global launches
    n_kv, n_pages, ps, hd = k_pages.shape
    B, Hq, qhd = q.shape
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        require(t.is_cuda and t.device == q.device,
                f"paged_attention: {name} must be on {q.device}, "
                f"got {t.device}")
        require(t.is_contiguous(), f"paged_attention: {name} must be "
                "contiguous")
    code = dtype_code(q, "paged_attention")
    require(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
            "paged_attention: q, k_pages and v_pages must share a dtype")
    require(page_table.dtype == torch.int32 and lengths.dtype == torch.int32,
            "paged_attention: page_table and lengths must be int32")
    require(v_pages.shape == k_pages.shape and qhd == hd,
            f"paged_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)} disagree")
    require(Hq % n_kv == 0 and Hq // n_kv <= 16,
            f"paged_attention: Hq={Hq} must be n_kv={n_kv} times a group "
            "of at most 16")
    require(16 <= hd <= 256 and hd & (hd - 1) == 0,
            f"paged_attention: head dim {hd} is not a power of two in "
            "[16, 256]")
    require(page_table.dim() == 2 and page_table.shape[0] == B
            and tuple(lengths.shape) == (B,),
            "paged_attention: page_table must be (B, max_pages), lengths (B,)")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    require(all(t.data_ptr() % 16 == 0 for t in (k_pages, v_pages)),
            "paged_attention: k_pages/v_pages must be 16-byte aligned")
    mp = page_table.shape[1]
    if n_split is None:
        n_split = lib.paged_attention_num_splits(B, n_kv, mp, ps, hd,
                                                 _sms(q.device))
    g = Hq // n_kv
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty((B, n_kv, n_split, g, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, n_kv, n_split, g, 2), dtype=torch.float32,
                              device=q.device)
    rc = lib.paged_attention_launch(
        code, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        B, Hq, n_kv, n_pages, ps, hd, mp, int(window), float(scale), n_split,
        stream_ptr(q.device))
    raise_on_error(rc, lib, "paged_attention_error_string", "paged_attention")
    launches += 1
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, hd); k/v_pages: (n_kv, n_pages, page_size, hd);
    page_table: (B, max_pages); lengths: (B,) -> (B, Hq, hd)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    return paged_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                                window=window, scale=scale)
