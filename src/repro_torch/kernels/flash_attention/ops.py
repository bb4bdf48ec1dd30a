"""Public entry point for flash attention, forward and backward.

Dispatch is on the tensors' device, nothing else: a CPU tensor runs the
plain versions (``ref.py``); a CUDA tensor launches the hand-written
kernels of ``repro_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` or raises. There is no fallback between the
two. Which kernel runs is decided by the dtype and the head dim, as the
``.cu`` files decide it (``fwd_route``, ``fwd_kernel``, ``bwd_route`` read
their getters):

- bfloat16 at d 64, 128 and 256 ("wgmma"): TMA + ``wgmma``
  (FlashAttention-3 shape: a producer warp and a two-stage mbarrier ring
  of K and V tiles, consumer warpgroups of 64 query rows taking turns, a
  persistent grid); blocks of 128 or 64 rows by shape (``fwd_kernel``):
  at d 64 and 128, 128 rows on 128-key tiles from 1024 query rows up when
  their tiles give every SM one, else 64 rows on 64-key tiles, two an SM;
  at d 256, 64-key tiles either way, 128 rows wherever their tiles give
  every SM one;
- float32 at d 64 and 128 ("wgmma-3xbf16"): the same kernel on bf16 parts
  (each float32 operand as hi = bf16(x) and lo = bf16(x - hi), written by
  a first kernel for q, k and v into a scratch buffer the wrapper
  allocates; each product as lo hi + hi lo + hi hi summed in float32; P
  split into its two parts, not rounded), at d 128 on d 256's tile plan;
- bfloat16 at d 16, 32 and 80: the ``mma.sync`` m16n8k16 kernel
  (FlashAttention-2 schedule, 64-row query tiles, KV tiles of 64 rows);
- float32 at d 16, 32, 80 and 256: the FMA kernel.

The first versions (``mma.sync`` for bfloat16, FMA for float32) still run
at any head dim through ``flash_attention_fwd_cuda(..., kernel=)``, for
timing one against the other.

The backward's routes (``bwd_route``): bfloat16 at d 64, 128 and 256 runs
TMA + ``wgmma`` kernels (at d 256 on 64-key blocks whose two consumer
warpgroups split dV and dK), at d 16, 32 and 80 ``mma.sync`` ones;
float32 at d 64 and 128 runs the same kind of ``wgmma`` kernels on
3xBF16 ("wgmma-3xbf16": each float32 operand as two bf16 parts, each
product as three bf16 ones summed in float32, within 1e-4 of the largest
gradient where one TF32 or bf16 pass is not), at d 16, 32, 80 and 256
FMA ones. ``fwd_plan`` and ``bwd_plan`` mirror the ``wgmma`` kernels' tile
plans (the tiles each block walks, those a mask edge crosses) in Python,
so the CPU tests hold them to the JAX kernel's mask; ``fwd_plan_cu``
reads the forward ``.cu``'s own.

Both take head dims ``HEAD_DIMS``. ``flash_attention`` is a
``torch.autograd.Function``. When an input needs a grad, its forward also
returns each row's log-sum-exp L (the kernel writes it beside the output;
on the CPU ``flash_attention_lse_ref``'s, from the same pass over the
scores as the output) and saves q, k, v, out and L; its
backward computes the grads from them: on a card the kernels of
``flash_attention_bwd.cu`` (D = rowsum(dO O), dK/dV, dQ; on the tensor
cores but float32 at d 16, 32, 80 and 256), on the CPU the dense float32
``flash_attention_bwd_ref``. The JAX package's ``custom_vjp`` instead
takes the vjp of its plain version (``_bwd_vjp``); the gradient is the
same function.

``launches`` counts forward calls that launched and ``bwd_launches`` the
backward's (one a call, whatever device kernels it runs: two on the
forward's "wgmma-3xbf16", the parts and then the attention; CPU calls
count in neither), so a run can show that its prefill or training path
went through the kernels; under ``torch.utils.checkpoint`` the
recomputed forward launches again.

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
                i, i, p, p, p, p, p,        # dtype, kernel, q, k, v, o, lse
                p,                          # split
                i, i, i, i, i, i, i, i,     # B, Hq, Hkv, Sq, Sk, d, causal, window
                f, p]                       # scale, stream
            lib.flash_attention_fwd_route.argtypes = [i, i]
            lib.flash_attention_fwd_route.restype = i
            lib.flash_attention_fwd_kernel.argtypes = [i, i, i, i, i]
            lib.flash_attention_fwd_kernel.restype = i
            lib.flash_attention_fwd_plan.argtypes = [
                i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_ulonglong)]
            lib.flash_attention_fwd_plan.restype = None
        else:
            lib.flash_attention_bwd_launch.argtypes = [
                i, i, p, p, p, p, p,        # dtype, kernel, q, k, v, o, dO
                p, p, p, p,                 # lse, delta, part, split
                p, p, p,                    # dq, dk, dv
                i, i, i, i, i, i, i, i, i,  # B, Hq, Hkv, Sq, Sk, d, causal,
                                            # window, splits
                i, f, p]                    # only, scale, stream
            lib.flash_attention_bwd_key_block.argtypes = [i, i, i]
            lib.flash_attention_bwd_key_block.restype = i
            lib.flash_attention_bwd_route.argtypes = [i, i]
            lib.flash_attention_bwd_route.restype = i
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


# the routes of both directions (``fwd_route``, ``bwd_route``; the
# backward's ``kernel`` argument) and the forward's kernels (``fwd_kernel``,
# its launcher's ``kernel`` argument: the index + 1), as the .cu files
# number them; "wgmma-3xbf16" is float32 on bf16 parts
ROUTES = ("fma", "mma.sync", "wgmma", "wgmma-3xbf16")
FWD_KERNELS = ("fma", "mma.sync", "wgmma-64", "wgmma-128")


def fwd_route(dtype: torch.dtype, d: int) -> str:
    """The forward kernel's route for a ``dtype`` call at head dim ``d``,
    as ``flash_attention_fwd.cu`` chooses it (builds the library): "wgmma"
    (TMA ring + wgmma: bfloat16 at d 64, 128 and 256), "wgmma-3xbf16" (the
    same kernel on bf16 parts: float32 at d 64 and 128), "mma.sync"
    (bfloat16 elsewhere) or "fma" (float32 elsewhere)."""
    return ROUTES[_lib().flash_attention_fwd_route(DTYPE_CODES[dtype], d)]


def fwd_kernel(dtype: torch.dtype, d: int, B: int, Hq: int, Sq: int) -> str:
    """The forward kernel a call at these shapes runs, as the ``.cu``
    chooses it from shapes alone (builds the library): "fma", "mma.sync",
    "wgmma-64" or "wgmma-128" (the ``wgmma`` routes' rows a block)."""
    return FWD_KERNELS[_lib().flash_attention_fwd_kernel(
        DTYPE_CODES[dtype], d, B, Hq, Sq)]


def _key_tiles(Sq, Sk, causal, window, q_lo, rows, keys):
    """``key_tiles`` of ``csrc/attention.cuh`` for rows [q_lo, q_lo +
    rows): the key tiles of ``keys`` keys they see, [begin, end)."""
    off = Sk - Sq
    k_end = min(Sk, min(q_lo + rows, Sq) - 1 + off + 1) if causal else Sk
    k_begin = max(0, q_lo + off - window + 1) if window > 0 else 0
    begin = k_begin // keys
    return begin, (-(-k_end // keys) if k_end > k_begin else begin)


def _edge_tile(Sq, Sk, causal, window, q_lo, rows, k_lo, keys) -> bool:
    """``edge_tile``: whether a mask edge (Sk, the causal diagonal, the
    window's start) crosses rows [q_lo, q_lo + rows) x keys [k_lo, k_lo +
    keys), so that the kernel tests the tile's scores one by one."""
    off = Sk - Sq
    return (k_lo + keys > Sk or (causal and k_lo + keys - 1 > q_lo + off)
            or (window > 0 and k_lo <= q_lo + rows - 1 + off - window))


def fwd_plan(Sq: int, Sk: int, causal: bool, window: int, rows: int,
             keys: int) -> list[tuple[int, int, tuple]]:
    """The ``wgmma`` forward's plan, in Python: for each query tile of
    ``rows`` rows, (kt_begin, kt_end, edges) -- the key tiles of ``keys``
    keys its rows see, and for each of them whether a mask edge crosses
    it. The kernel walks a block's range at its rows (64 or 128) and tests
    edges a warpgroup's 64 rows at a time."""
    plan = []
    for qt in range(-(-Sq // rows)):
        q_lo = qt * rows
        b, e = _key_tiles(Sq, Sk, causal, window, q_lo, rows, keys)
        plan.append((b, e, tuple(
            _edge_tile(Sq, Sk, causal, window, q_lo, rows, t * keys, keys)
            for t in range(b, e))))
    return plan


def fwd_plan_cu(Sq: int, Sk: int, causal: bool, window: int, rows: int,
                keys: int) -> list[tuple[int, int, tuple]]:
    """``fwd_plan`` as ``flash_attention_fwd.cu`` computes it (its
    ``flash_attention_fwd_plan`` getter, the kernel's own functions; at
    most 64 key tiles a query tile; builds the library)."""
    lib = _lib()
    plan = []
    for qt in range(-(-Sq // rows)):
        b, e, edges = ctypes.c_int(), ctypes.c_int(), ctypes.c_ulonglong()
        lib.flash_attention_fwd_plan(Sq, Sk, int(bool(causal)), int(window),
                                     rows, keys, qt, ctypes.byref(b),
                                     ctypes.byref(e), ctypes.byref(edges))
        plan.append((b.value, e.value, tuple(
            bool(edges.value >> t & 1) for t in range(e.value - b.value))))
    return plan


def _query_tiles(Sq, Sk, causal, window, k_lo, k_hi, rows):
    """``query_tiles`` of ``csrc/attention.cuh``: the query tiles of
    ``rows`` rows that keys [k_lo, k_hi] can be seen by, (begin, count)."""
    off = Sk - Sq
    r_begin = max(0, k_lo - off) if causal else 0
    r_end = min(Sq, k_hi - off + window) if window > 0 else Sq
    begin = r_begin // rows
    return begin, (-(-r_end // rows) - begin if r_end > r_begin else 0)


def _bwd_step(Sq, Sk, causal, window, q_lo, rows, kw) -> str:
    """What a dK/dV consumer warpgroup does with its 64 keys [kw, kw + 64)
    at the query step of rows [q_lo, q_lo + rows): "idle" (no row sees
    them), "edge" (a mask edge, Sq or Sk crosses the tile: each score is
    tested) or "whole", as ``dkdv_block`` and ``dkdv_parts`` decide it."""
    off = Sk - Sq
    if (kw >= Sk or (causal and kw > q_lo + rows - 1 + off)
            or (window > 0 and kw + 63 <= q_lo + off - window)):
        return "idle"
    if (kw + 64 > Sk or q_lo + rows > Sq or (causal and kw + 63 > q_lo + off)
            or (window > 0 and kw <= q_lo + rows - 1 + off - window)):
        return "edge"
    return "whole"


def _dq_step(Sq, Sk, causal, window, rw, k_lo, keys) -> str:
    """The same for a dQ consumer warpgroup's 64 rows [rw, rw + 64) at the
    key step [k_lo, k_lo + keys), as ``dq_block`` and ``dq_parts``
    decide it."""
    off = Sk - Sq
    if (rw >= Sq or (causal and k_lo > rw + 63 + off)
            or (window > 0 and k_lo + keys - 1 <= rw + off - window)):
        return "idle"
    return ("edge" if _edge_tile(Sq, Sk, causal, window, rw, 64, k_lo, keys)
            else "whole")


def bwd_plan(Sq: int, Sk: int, causal: bool, window: int, kv_keys: int,
             q_rows: int, dq_rows: int, dq_keys: int, shared: bool):
    """The ``wgmma`` backward's plan, in Python, as its kernels walk it:
    (dkdv, dq). ``dkdv``: for each key block of ``kv_keys`` keys, the
    query steps of ``q_rows`` rows it takes, each as (q_lo, steps), one
    ``_bwd_step`` a consumer warpgroup: both on the block's 64 keys when
    ``shared`` (the d-256 and 3xBF16-d-128 kernels, whose warpgroups split
    dV and dK), else each on its own 64. ``dq``: for each dQ block of
    ``dq_rows`` rows, its key steps of ``dq_keys`` keys as (k_lo, steps),
    one ``_dq_step`` for each 64 rows (with ``shared`` blocks of 64 rows,
    each step taken by the warpgroup whose turn it is)."""
    dkdv = []
    for kb in range(-(-Sk // kv_keys)):
        k_lo = kb * kv_keys
        b, n = _query_tiles(Sq, Sk, causal, window, k_lo,
                            min(k_lo + kv_keys, Sk) - 1, q_rows)
        kws = [k_lo] * 2 if shared else range(k_lo, k_lo + kv_keys, 64)
        dkdv.append([(t * q_rows, tuple(
            _bwd_step(Sq, Sk, causal, window, t * q_rows, q_rows, kw)
            for kw in kws)) for t in range(b, b + n)])
    dq = []
    for qt in range(-(-Sq // dq_rows)):
        q_lo = qt * dq_rows
        b, e = _key_tiles(Sq, Sk, causal, window, q_lo, dq_rows, dq_keys)
        dq.append([(t * dq_keys, tuple(
            _dq_step(Sq, Sk, causal, window, rw, t * dq_keys, dq_keys)
            for rw in range(q_lo, q_lo + dq_rows, 64))) for t in range(b, e)])
    return dkdv, dq


# keys a dK/dV block of the d-256 kernel (bfloat16 at d 256, float32 at
# d 128), ``flash_attention_bwd_key_block``'s figure there (the CPU tests
# size group splits with it; the card tests hold the two equal)
PART_KEY_BLOCK = 64


def split_heads(g: int, splits: int) -> list[range]:
    """The q heads (offsets in a GQA group of ``g``) that each of the
    ``splits`` parts of a dK/dV column takes, as the kernels cut them:
    part s takes [s g / splits, (s + 1) g / splits)."""
    return [range(s * g // splits, (s + 1) * g // splits)
            for s in range(splits)]


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0, scale: float | None = None,
                             lse: bool = False, kernel: str | None = None):
    """Launch the CUDA kernel. q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d),
    contiguous, on one CUDA device, one float32 or bfloat16 dtype. Returns
    out, or with ``lse`` (out, L): L float32 (B, Hq, Sq), each row's
    log-sum-exp (out is the same bits either way). ``kernel`` runs one of
    ``FWD_KERNELS`` in place of the one ``fwd_kernel`` names (the first
    version of the dtype, "fma" or "mma.sync", at any head dim; the
    ``wgmma`` kernels where ``fwd_route`` names them; the launcher refuses
    any other), to time one against another; it is counted like any
    launch."""
    global launches
    code = _check((("q", q), ("k", k), ("v", v)), q, "flash_attention")
    _check_shapes(q, k, v, "flash_attention")
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        require((q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0,
                "flash_attention: the bfloat16 kernels' 16-byte loads and "
                "TMA need 16-byte aligned q, k and v")
    require(kernel is None or kernel in FWD_KERNELS,
            f"flash_attention: kernel {kernel!r} is not one of "
            f"{FWD_KERNELS}")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    L = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
         if lse else None)
    if B == 0 or Sq == 0 or Hq == 0:
        return (out, L) if lse else out
    require(Sk > 0, "flash_attention: no keys")
    lib = _lib()
    # the 3xBF16 kernels' bf16 parts of q, k and v: [hi | lo] a row
    split = (torch.empty(2 * B * (Hq * Sq + 2 * Hkv * Sk) * d,
                         dtype=torch.bfloat16, device=q.device)
             if q.dtype == torch.float32 and (
                 kernel or fwd_kernel(q.dtype, d, B, Hq, Sq)).startswith(
                     "wgmma") else None)
    rc = lib.flash_attention_fwd_launch(
        code, FWD_KERNELS.index(kernel) + 1 if kernel else 0, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(),
        L.data_ptr() if lse else None,
        split.data_ptr() if split is not None else None, B, Hq, Hkv, Sq, Sk,
        d, int(bool(causal)), int(window), float(scale),
        stream_ptr(q.device))
    raise_on_error(rc, lib, "flash_attention_fwd_error_string",
                   "flash_attention")
    launches += 1
    return (out, L) if lse else out


def _bwd_kernel_code(kernel: str | None) -> int:
    """The backward launcher's ``kernel`` argument: 0 for the route the
    .cu chooses, else the route's number + 1."""
    require(kernel is None or kernel in ROUTES,
            f"flash_attention_bwd: kernel {kernel!r} is not one of {ROUTES}")
    return 0 if kernel is None else ROUTES.index(kernel) + 1


def bwd_key_block(dtype: torch.dtype, d: int,
                  kernel: str | None = None) -> int:
    """Keys a block of the backward's dK/dV kernel for ``dtype`` at head
    dim ``d`` (on ``kernel``'s route, else the chosen one), as
    ``flash_attention_bwd.cu`` compiles it (builds the library); 0 where
    the route does not run that call."""
    return _lib("flash_attention_bwd").flash_attention_bwd_key_block(
        DTYPE_CODES[dtype], d, _bwd_kernel_code(kernel))


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernels a ``dtype`` call at head dim ``d`` runs, as
    ``flash_attention_bwd.cu`` chooses them (builds the library): "wgmma"
    (TMA ring + wgmma, bfloat16 at d 64, 128 and 256), "mma.sync"
    (bfloat16 elsewhere), "wgmma-3xbf16" (float32 at d 64 and 128 as bf16
    parts on the same kind of kernel) or "fma" (float32 elsewhere)."""
    return ROUTES[_lib("flash_attention_bwd").flash_attention_bwd_route(
        DTYPE_CODES[dtype], d)]


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
                             scale: float | None = None,
                             kernel: str | None = None, only: int = 0):
    """Launch the backward kernels. q, out, dout: (B, Hq, Sq, d); k, v: (B,
    Hkv, Sk, d), one float32 or bfloat16 dtype; lse: float32 (B, Hq, Sq),
    the forward's L; all contiguous on one CUDA device. Returns (dq, dk,
    dv), counted once in ``bwd_launches``. ``kernel`` runs one of
    ``ROUTES`` in place of the one ``bwd_route`` names (the first version
    of the dtype, "fma" or "mma.sync", where it ran before), to time one
    against the other; ``only`` (1: the dK/dV blocks, 2: the dQ blocks)
    restricts the one-launch routes' main kernel to half its blocks,
    leaving the other half's outputs undefined: ``chip_profile.py bwd``'s
    split of a call."""
    global bwd_launches
    what = "flash_attention_bwd"
    code_k = _bwd_kernel_code(kernel)
    require(only in (0, 1, 2), f"{what}: only={only!r} is not 0, 1 or 2")
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
    key_block = lib.flash_attention_bwd_key_block(code, d, code_k)
    require(key_block > 0, f"{what}: kernel {kernel!r} does not run "
            f"{q.dtype} at head dim {d}")
    splits = group_splits(B, Hkv, Sk, Hq // Hkv, key_block,
                          device_sms(q.device))
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((splits, 2, *k.shape), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    # the 3xBF16 route's bf16 parts of q, dO, k and v: [hi | lo] a row
    split = (torch.empty(2 * B * (2 * Hq * Sq + 2 * Hkv * Sk) * d,
                         dtype=torch.bfloat16, device=q.device)
             if (kernel or bwd_route(q.dtype, d)) == "wgmma-3xbf16"
             else None)
    rc = lib.flash_attention_bwd_launch(
        code, code_k, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        part.data_ptr() if part is not None else None,
        split.data_ptr() if split is not None else None, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, d,
        int(bool(causal)), int(window), splits, only, float(scale),
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
