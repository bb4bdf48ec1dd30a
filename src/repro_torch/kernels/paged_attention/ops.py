"""Public entry point for paged decode attention.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain version (``ref.py``); a CUDA tensor launches the hand-written kernel
``repro_torch/csrc/paged_attention.cu`` or raises. There is no fallback
between the two.

Two kernels live in that file; ``kernel_choice(dtype, g, hd)``, a pure
function of the shapes decided before the launch, names the one that runs:
"mma" (bfloat16, head dims ``MMA_HEAD_DIMS``: the group products on the
tensor cores, pages streamed through a cp.async ring) or "fma" (float32,
and bfloat16 at head dim 256). Both take exactly ``HEAD_DIMS``.

Both cut the work by position: block (kv head, slot, span) owns
``span_pages`` whole pages of its slot (``span_pages``: from shapes only,
so the host never reads the lengths), and a second kernel merges the
spans. ``span_ranges`` is the plan in plain Python: the positions each
block covers.

``launches`` counts wrapper calls that launch a kernel (CPU calls do not
count), so a run can show that its decode path went through it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (device_sms, dtype_code,
                                         raise_on_error, require, stream_ptr)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# csrc/paged_attention.cu's kernels, the head dims both take (its
# head_dim_ok), and those "mma" is compiled for
KERNEL_CODES = {"fma": 0, "mma": 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
MMA_HEAD_DIMS = (16, 32, 64, 80, 128)
# the FMA kernel's group-size variants: exact sizes, else a bound of 16
FMA_GROUPS = (1, 2, 3, 4, 8)
MAX_GROUP = 16
# the span a block owns, in tokens, before the occupancy rule halves it,
# and the fewest blocks per SM a full table must give: 16 pages at
# chip_smoke.py's 129-page table, 8 at the llama pod's 64
# (chip_profile.py times K1 at other spans beside the plan)
SPAN_TOKENS = 256
MIN_BLOCKS_PER_SM = 2

launches = 0
_bound = False


def _lib():
    global _bound
    lib = _build.load("paged_attention")
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            i, i, p, p, p, p, p, p,         # dtype, kernel, q, k, v, table,
                                            # lengths, out
            p, p,                           # part_acc, part_ml (span scratch)
            i, i, i, i, i, i, i, i,         # B, Hq, n_kv, n_pages, ps, hd, mp, window
            ctypes.c_float, i, p]           # scale, span_pages, stream
        lib.paged_attention_launch.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def kernel_choice(dtype: torch.dtype, g: int, hd: int) -> tuple[str, int]:
    """(kernel, variant) that ``paged_attention_cuda`` launches for query
    groups of ``g`` heads of dim ``hd``: ("mma", hd) for bfloat16 with hd
    in MMA_HEAD_DIMS (the 16 MMA rows hold any group up to 16), else
    ("fma", g's compiled group variant)."""
    if dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS:
        return "mma", hd
    return "fma", g if g in FMA_GROUPS else MAX_GROUP


def span_pages(B: int, n_kv: int, mp: int, ps: int, sm_count: int) -> int:
    """Pages a block owns: SPAN_TOKENS worth of whole pages (at least
    one), halved while a table full to its ``mp`` pages would give fewer
    than MIN_BLOCKS_PER_SM blocks an SM. Shapes only: the lengths stay on
    the device, and blocks past a slot's length exit at once."""
    sp = min(mp, max(1, SPAN_TOKENS // ps))
    while sp > 1 and B * n_kv * -(-mp // sp) < MIN_BLOCKS_PER_SM * sm_count:
        sp //= 2
    return sp


def span_ranges(lengths, window: int, ps: int, mp: int,
                span_pages: int) -> list[list[tuple[int, int, int]]]:
    """The plan the kernels follow, per slot: (span, first, end) for each
    block whose span holds live positions, which it covers as [first,
    end). Live positions are [max(0, length - window), length) (window 0:
    from 0), cut to the table's mp * ps."""
    span_tok = span_pages * ps
    plan = []
    for length in (int(n) for n in lengths):
        lo = max(0, length - window) if window > 0 else 0
        hi = min(length, mp * ps)
        blocks = []
        for s in range(-(-mp // span_pages)):
            first, end = max(lo, s * span_tok), min(hi, (s + 1) * span_tok)
            if end > first:
                blocks.append((s, first, end))
        plan.append(blocks)
    return plan


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, *, window: int = 0,
                         scale: float | None = None,
                         span: int | None = None,
                         kernel: str | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. Every tensor must be contiguous and on one
    CUDA device; q/k/v share a float32 or bfloat16 dtype (16-byte aligned);
    table and lengths are int32; the head dim is one of HEAD_DIMS. ``span`` is the pages a block owns (None: ``span_pages``;
    the table's width: one block per (slot, kv head), no merge kernel).
    ``kernel`` names the kernel (None: ``kernel_choice``; "fma" runs the
    FMA kernel on bfloat16 too, for comparison)."""
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
    require(Hq % n_kv == 0 and Hq // n_kv <= MAX_GROUP,
            f"paged_attention: Hq={Hq} must be n_kv={n_kv} times a group "
            f"of at most {MAX_GROUP}")
    require(hd in HEAD_DIMS,
            f"paged_attention: head dim {hd} not in {HEAD_DIMS}")
    require(page_table.dim() == 2 and page_table.shape[0] == B
            and tuple(lengths.shape) == (B,),
            "paged_attention: page_table must be (B, max_pages), lengths (B,)")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    require(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
            "paged_attention: q, k_pages and v_pages must be 16-byte aligned")
    mp = page_table.shape[1]
    g = Hq // n_kv
    if kernel is None:
        kernel = kernel_choice(q.dtype, g, hd)[0]
    require(kernel == "fma" or kernel_choice(q.dtype, g, hd)[0] == kernel,
            f"paged_attention: kernel {kernel} does not take {q.dtype} at "
            f"head dim {hd}")
    if span is None:
        span = span_pages(B, n_kv, mp, ps, device_sms(q.device))
    require(span > 0, f"paged_attention: span {span} must be positive")
    n_spans = -(-mp // span)
    part_acc = part_ml = None
    if n_spans > 1:
        part_acc = torch.empty((B, n_kv, n_spans, g, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, n_kv, n_spans, g, 2), dtype=torch.float32,
                              device=q.device)
    rc = lib.paged_attention_launch(
        code, KERNEL_CODES[kernel], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        B, Hq, n_kv, n_pages, ps, hd, mp, int(window), float(scale), span,
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
