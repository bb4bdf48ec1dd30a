"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and skips without one (the kernels
have no CPU mode). The file imports neither jax nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: 1e-4 in float32 (the kernel sums in another order), 3e-2 in
bfloat16 (as the JAX kernel suites). The matmul within 1e-4 x max |ref| in
float32 (its FMA chain sums K products in another order than cuBLAS) and
2^-7 x max |ref| in bfloat16 (one bf16 rounding of the float32 sum). The
scans are float32 only: the SSD
kernel within 1e-4 of its plain chunked version relative to the output's
max (the JAX suite's bound: at mamba2-2.7b's widths each output sums 128
state and 256 time products, and the two versions round them in other
orders), the RG-LRU kernel within 1e-5 absolute of the sequential version
scaled by max(1, max |h|) (its tiles' carries compose the recurrence in
another order, fixed, so repeated calls agree bit for bit). K2's
backward kernels against the dense float32 plain backward from the same
out and L, relative to the largest plain gradient: 1e-4 in float32 (FMA
sums in another order), 2^-7 in bfloat16 (P and dS are rounded to bf16
before their products, as the forward rounds P); the forward's L within
1e-4 of max(1, max |L|) of the plain log-sum-exp. K5's backward kernels
against the plain backward ``ssd_bwd_ref`` on the same inputs, within
1e-4 of each input's largest gradient (3xTF32 products and fixed-order
sums, in another order than the plain version's).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import _ssd_chunked, ssd_bwd_ref

pytestmark = pytest.mark.cuda

PA_CASES = [
    # B, n_kv, g, hd, page_size, max_pages, window, dtype
    (4, 2, 2, 16, 8, 4, 0, "float32"),
    (3, 1, 8, 32, 16, 3, 0, "float32"),      # MQA
    (2, 4, 1, 64, 64, 2, 0, "float32"),      # MHA, big pages
    (4, 2, 3, 16, 8, 6, 12, "float32"),      # sliding window
    (2, 2, 2, 32, 16, 4, 0, "bfloat16"),
    (2, 1, 4, 64, 64, 3, 40, "bfloat16"),    # window + big pages
    (8, 8, 3, 128, 16, 33, 0, "bfloat16"),   # llama3.2-3b decode
    (2, 2, 16, 256, 16, 5, 0, "float32"),    # widest group and head dim
    # llama3.2-3b decode with a 1-token and a 2048-token slot (a table of
    # 129 pages), plain and windowed: the span plan and the page ring where
    # one slot is longest
    (8, 8, 3, 128, 16, 129, 0, "bfloat16"),
    (8, 8, 3, 128, 16, 129, 200, "bfloat16"),
    # the tensor-core kernel at hd 16 (half-page tiles), a full 16-row
    # group on pages of 24 with a window; the FMA kernel's group of 4 and
    # bfloat16 at hd 256
    (2, 2, 2, 16, 8, 4, 0, "bfloat16"),
    (3, 2, 16, 64, 24, 5, 30, "bfloat16"),
    (2, 1, 4, 64, 64, 3, 40, "float32"),
    (2, 2, 16, 256, 16, 5, 0, "bfloat16"),
    # stablelm-3b decode: MHA (g 1: one of the tensor-core kernel's 16
    # rows) at head dim 80, pages of 16, poisoned tails, both kernels
    (8, 32, 1, 80, 16, 64, 0, "bfloat16"),
    (8, 32, 1, 80, 16, 64, 0, "float32"),
    # the decodes of nemotron-4-15b (48 q / 8 kv heads: a GQA group of 6
    # in the 16 MMA rows), moonshot-v1-16b-a3b (MHA at hd 128),
    # musicgen-medium (MHA, 24 heads of 64) and internvl2-2b (g 2, hd 128)
    (8, 8, 6, 128, 16, 64, 0, "bfloat16"),
    (8, 8, 6, 128, 16, 64, 0, "float32"),
    (8, 16, 1, 128, 16, 64, 0, "bfloat16"),
    (8, 24, 1, 64, 16, 64, 0, "bfloat16"),
    (8, 24, 1, 64, 16, 64, 0, "float32"),
    (8, 8, 2, 128, 16, 64, 0, "bfloat16"),
]

FA_CASES = [
    # B, Hq, Hkv, Sq, Sk, d, causal, window, dtype
    (2, 4, 2, 128, 128, 64, True, 0, "float32"),
    (1, 8, 1, 256, 256, 32, True, 0, "float32"),     # MQA
    (2, 4, 4, 128, 256, 64, True, 64, "float32"),    # window + kv>q
    (1, 2, 2, 128, 128, 128, False, 0, "float32"),   # bidirectional
    (1, 4, 2, 256, 256, 64, True, 0, "bfloat16"),
    (1, 2, 1, 64, 192, 128, True, 128, "bfloat16"),
    (1, 24, 8, 128, 328, 128, True, 0, "float32"),   # ragged suffix prefill
    (1, 4, 2, 40, 40, 16, True, 0, "float32"),       # smoke width, ragged
    (1, 4, 1, 33, 97, 256, True, 0, "bfloat16"),     # d=256, ragged
    # recurrentgemma-2b's local-attention prefill: 2304 tokens past the
    # 2048 window, so later query tiles start their key loop late
    (1, 10, 1, 2304, 2304, 256, True, 2048, "float32"),
    (1, 10, 1, 2304, 2304, 256, True, 2048, "bfloat16"),
    (2, 10, 1, 100, 137, 256, True, 48, "float32"),  # its widths, ragged
    # the same in bf16: a short window, where a one-column slip of the
    # tensor-core kernel's boundary-tile mask shows
    (2, 10, 1, 100, 137, 256, True, 48, "bfloat16"),
    # the tensor-core kernel at every head dim, ragged, and bidirectional
    (1, 4, 2, 40, 40, 16, True, 0, "bfloat16"),      # smoke width, ragged
    (1, 8, 1, 256, 256, 32, True, 0, "bfloat16"),    # MQA
    (1, 24, 8, 128, 328, 128, True, 0, "bfloat16"),  # ragged suffix prefill
    (1, 2, 2, 128, 128, 128, False, 0, "bfloat16"),  # bidirectional
    # stablelm-3b's prefill: 32 q and 32 kv heads of 80, a 512-token
    # prompt, and a suffix prefill over a 200-token prefix
    (1, 32, 32, 512, 512, 80, True, 0, "bfloat16"),
    (1, 32, 32, 512, 512, 80, True, 0, "float32"),
    (1, 32, 32, 128, 328, 80, True, 0, "bfloat16"),
    (1, 32, 32, 128, 328, 80, True, 0, "float32"),
    # nemotron-4-15b's 512-token prefill (Hq 48 over Hkv 8), moonshot's
    # (16/16 at 128), and the frontend archs' packed prefills of F + P
    # rows: musicgen-medium (24 heads of 64, 64 + 300 rows) and
    # internvl2-2b (16 over 8 at 128, 256 + 512 rows)
    (1, 48, 8, 512, 512, 128, True, 0, "bfloat16"),
    (1, 48, 8, 512, 512, 128, True, 0, "float32"),
    (1, 16, 16, 512, 512, 128, True, 0, "bfloat16"),
    (1, 24, 24, 364, 364, 64, True, 0, "bfloat16"),
    (1, 24, 24, 364, 364, 64, True, 0, "float32"),
    (1, 16, 8, 768, 768, 128, True, 0, "bfloat16"),
]


# tests/test_kernels.py:93 (B, S, R), plus recurrentgemma-2b's prefill
# widths: a 2304-token prompt and a ragged batch of 3; then one step, the
# recurrentgemma pod's 64- and 512-token prefills, a ragged R (200: a
# slab of 8 live channels) and three 2304-token prompts. (3, 32, 512) and
# (1, 1, 2560) are one time chunk (no look-back), the others several.
RG_CASES = [(2, 64, 128), (1, 100, 256), (3, 32, 512), (1, 128, 128),
            (1, 2304, 2560), (3, 100, 2560), (1, 1, 2560), (1, 64, 2560),
            (1, 512, 2560), (1, 100, 200), (3, 2304, 2560)]

# tests/test_kernels.py:121 (b, S, H, P, N, chunk), plus mamba2-2.7b's
# prefill widths (H 80, P 64, N 128, chunk 256) and a ragged chunk; the
# mamba2 pod's longest and shortest prefills (768 tokens: three chunks; 64);
# then a head dim of 96 (the 128-column slice, masked), a state of 30 (rows
# not 16-byte aligned) and a head dim of 144 (two slices)
SSD_CASES = [(2, 64, 4, 32, 32, 16), (1, 128, 8, 64, 128, 32),
             (2, 96, 2, 16, 64, 32), (1, 256, 4, 64, 128, 64),
             (1, 512, 80, 64, 128, 256), (2, 256, 80, 64, 128, 256),
             (1, 100, 3, 32, 48, 100), (1, 768, 80, 64, 128, 256),
             (1, 64, 80, 64, 128, 64), (1, 64, 2, 96, 48, 32),
             (1, 64, 2, 16, 30, 32), (1, 64, 2, 144, 16, 64)]

# tests/test_kernels.py:159 (M, K, N, dtype), a ragged shape no block
# divides, and llama3.2-3b's prefill MLP products for a 512-token prompt
# (gate/up, then down), which reach every compiled tile
# (test_mm_cases_cover_every_kernel_and_tile); then TMA's ragged edges (M,
# N and K off every tile, K and N multiples of 8), and bfloat16 that TMA
# cannot describe (N, then K, not a multiple of 8: the FMA kernel)
MM_CASES = [(256, 256, 256, "float32"), (128, 384, 256, "bfloat16"),
            (64, 64, 64, "float32"), (512, 128, 256, "bfloat16"),
            (100, 200, 300, "bfloat16"), (100, 200, 300, "float32"),
            (512, 3072, 8192, "bfloat16"), (512, 8192, 3072, "bfloat16"),
            (512, 3072, 8192, "float32"), (512, 8192, 3072, "float32"),
            (100, 200, 304, "bfloat16"), (96, 100, 136, "bfloat16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _tol(dt):
    return 3e-2 if dt == "bfloat16" else 1e-4


@pytest.mark.parametrize("case", PA_CASES, ids=str)
def test_paged_kernel_vs_plain(case, cuda):
    B, n_kv, g, hd, ps, mp, window, dt = case
    rng = np.random.default_rng(42)
    lengths = np.concatenate([[1, min(2048, mp * ps)],
                              rng.integers(1, mp * ps, max(0, B - 2))])
    lengths = lengths[:B].astype(np.int32)
    n_pages = sum(-(-int(n) // ps) for n in lengths) + 3
    free = list(range(1, n_pages))
    rng.shuffle(free)
    table = np.zeros((B, mp), np.int32)
    live = np.zeros((n_pages, ps), bool)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // ps)):
            table[b, j] = p = free.pop()
            live[p, :min(ps, int(lengths[b]) - j * ps)] = True
    q = rng.standard_normal((B, n_kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((n_kv, n_pages, ps, hd)).astype(np.float32)
    v = rng.standard_normal((n_kv, n_pages, ps, hd)).astype(np.float32)
    k[:, ~live] = 1e9            # garbage page, spare pages, page tails
    v[:, ~live] = 1e9
    t = lambda a: torch.from_numpy(a).to(cuda, getattr(torch, dt))  # noqa: E731
    args = (t(q), t(k), t(v), torch.from_numpy(table).to(cuda),
            torch.from_numpy(lengths).to(cuda))
    before = pa_ops.launches
    out = pa_ops.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert pa_ops.launches == before + 1
    ref = paged_attention_ref(*args, window=window)
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref.float()).abs().max()) < _tol(dt)
    # one span a block (the whole table: no merge kernel) computes the same
    one = pa_ops.paged_attention_cuda(*args, window=window, span=mp)
    assert float((one.float() - ref.float()).abs().max()) < _tol(dt)


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_kernel_vs_plain(case, cuda):
    B, Hq, Hkv, Sq, Sk, d, causal, window, dt = case
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda, getattr(torch, dt))
    q, k, v = t(B, Hq, Sq, d), t(B, Hkv, Sk, d), t(B, Hkv, Sk, d)
    before = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert float((out.float() - ref.float()).abs().max()) < _tol(dt)


def _rg_inputs(shape, cuda, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((1.0 / (1.0 + np.exp(-rng.standard_normal(shape))))
                         .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda)
    return a, b


def _rg_close(out, ref):
    scale = max(1.0, float(ref.abs().max()))
    return float((out - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("case", RG_CASES, ids=str)
def test_rglru_kernel_vs_plain(case, cuda):
    a, b = _rg_inputs(case, cuda)
    before = rg_ops.launches
    out = rg_ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rg_ops.launches == before + 1
    assert _rg_close(out, rglru_scan_ref(a, b))


# (B, S, R) whose plans on an H100's 132 SMs reach every tile length the
# kernel is compiled for (tests/test_torch_kernel_plans.py holds the plan
# to that), on ragged S and R (R 2563: rows not 16-byte aligned)
RG_TILE_SHAPES = [(1, S, R) for R in (2560, 2563) for S in (10, 20, 40, 100,
                                                              300)]


@pytest.mark.parametrize("shape", RG_TILE_SHAPES, ids=str)
def test_rglru_kernel_every_compiled_tile(shape, cuda):
    a, b = _rg_inputs(shape, cuda)
    out = rg_ops.rglru_scan_cuda(a, b)
    torch.cuda.synchronize()
    assert _rg_close(out, rglru_scan_ref(a, b))


def test_rglru_scratch_carries_over_calls(cuda):
    """The kernel leaves its flags and counters ready for the next call:
    calls that grow the scratch, shrink back and repeat (each a new epoch)
    stay within the tolerance and agree bit for bit (the look-back
    composes each carry in a fixed order)."""
    shapes = [(1, 64, 256), (1, 2304, 2560), (2, 33, 31), (1, 2304, 2560)]
    for i, shape in enumerate(shapes):
        a, b = _rg_inputs(shape, cuda, seed=i)
        ref = rglru_scan_ref(a, b)
        outs = [rg_ops.rglru_scan_cuda(a, b) for _ in range(20)]
        torch.cuda.synchronize()
        assert _rg_close(outs[0], ref)
        assert all(torch.equal(out, outs[0]) for out in outs[1:])


def test_rglru_is_one_device_kernel_a_call(cuda):
    """One call, one device kernel (no summary pass, no memset once the
    scratch exists)."""
    from torch.profiler import ProfilerActivity, profile
    a, b = _rg_inputs((1, 2304, 2560), cuda)
    rg_ops.rglru_scan_cuda(a, b)             # builds and sizes the scratch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            rg_ops.rglru_scan_cuda(a, b)
        torch.cuda.synchronize()
    runs = [e for e in prof.events() if e.device_type.name == "CUDA"]
    assert len(runs) == 4 and all("rglru_scan_kernel" in e.name
                                  for e in runs), [e.name for e in runs]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_kernel_vs_plain(case, cuda):
    b, S, H, P, N, chunk = case
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    x = t(rng.standard_normal((b, S, H, P)))
    dt = t(np.log1p(np.exp(rng.standard_normal((b, S, H)))))
    A = t(-np.exp(0.5 * rng.standard_normal(H)))
    B = t(rng.standard_normal((b, S, N)))
    C = t(rng.standard_normal((b, S, N)))
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    ry, rstate = _ssd_chunked(x, dt, A, B, C, chunk)
    assert float((y - ry).abs().max()) <= 1e-4 * float(ry.abs().max())
    assert float((state - rstate).abs().max()) <= \
        1e-4 * float(rstate.abs().max())


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 4, 16, device=cuda, dtype=torch.float16)
    pages = torch.zeros(2, 3, 8, 16, device=cuda, dtype=torch.float16)
    table = torch.zeros(2, 2, device=cuda, dtype=torch.int32)
    lens = torch.ones(2, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="not supported"):
        pa_ops.paged_attention(q, pages, pages, table, lens)
    x = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(1, 8, 2, 16, device=cuda).transpose(1, 2)
        fa_ops.flash_attention(y, y, y)
    a = torch.zeros(1, 8, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        rg_ops.rglru_scan(a, a)
    z = torch.zeros
    with pytest.raises(ValueError, match="must divide"):
        ssd_ops.ssd(z(1, 12, 2, 16, device=cuda), z(1, 12, 2, device=cuda),
                    z(2, device=cuda), z(1, 12, 8, device=cuda),
                    z(1, 12, 8, device=cuda), 8)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_ops.ssd(z(1, 8, 2, 24, device=cuda), z(1, 8, 2, device=cuda),
                    z(2, device=cuda), z(1, 8, 8, device=cuda),
                    z(1, 8, 8, device=cuda), 8)
    with pytest.raises(TypeError, match="not supported"):
        h = z(4, 4, device=cuda, dtype=torch.float16)
        mm_ops.matmul(h, h)
    with pytest.raises(ValueError, match="contiguous"):
        mm_ops.matmul(z(8, 4, device=cuda).T, z(8, 3, device=cuda))
    with pytest.raises(ValueError, match="are for cpu tensors"):
        mm_ops.matmul(z(4, 4, device=cuda), z(4, 4, device=cuda), "cpu")


def test_mm_cases_cover_every_kernel_and_tile():
    """MM_CASES reach every (kernel, tile) csrc/matmul.cu compiles, and both
    kernels in bfloat16 (runs without a card: the choice is shape only)."""
    seen = {mm_ops.kernel_choice(M, N, K, getattr(torch, dt))
            for M, K, N, dt in MM_CASES}
    want = {(k, *t) for k, tiles in mm_ops.TILES.items() for t in tiles}
    assert seen == want
    bf16 = {mm_ops.kernel_choice(M, N, K, torch.bfloat16)[0]
            for M, K, N, dt in MM_CASES if dt == "bfloat16"}
    assert bf16 == {"wgmma", "fma"}


def test_pa_cases_cover_every_kernel_and_variant():
    """PA_CASES reach every (kernel, variant) csrc/paged_attention.cu
    compiles: the tensor-core kernel at each head dim, the FMA kernel at
    each group variant, and the FMA kernel in both dtypes (runs without a
    card: the choice is shape and dtype only)."""
    seen = {pa_ops.kernel_choice(getattr(torch, dt), g, hd)
            for B, n_kv, g, hd, ps, mp, w, dt in PA_CASES}
    want = ({("mma", d) for d in pa_ops.MMA_HEAD_DIMS}
            | {("fma", g) for g in (*pa_ops.FMA_GROUPS, pa_ops.MAX_GROUP)})
    assert seen == want
    fma = {dt for B, n_kv, g, hd, ps, mp, w, dt in PA_CASES
           if pa_ops.kernel_choice(getattr(torch, dt), g, hd)[0] == "fma"}
    assert fma == {"float32", "bfloat16"}


def test_ssd_cases_cover_every_p_slice():
    """SSD_CASES reach every P slice csrc/ssd.cu compiles, one head dim
    that fills no slice exactly and one that takes two slices."""
    assert {ssd_ops.p_tile(P) for b, S, H, P, N, q in SSD_CASES} == \
        set(ssd_ops.P_TILES)
    assert any(P not in ssd_ops.P_TILES and P < 128
               for b, S, H, P, N, q in SSD_CASES)
    assert any(P > ssd_ops.P_TILES[-1] for b, S, H, P, N, q in SSD_CASES)


@pytest.mark.parametrize("case", MM_CASES, ids=str)
def test_matmul_kernel_vs_plain(case, cuda):
    M, K, N, dt = case
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda, getattr(torch, dt))
    a, b = t(M, K), t(K, N)
    before = mm_ops.launches
    out = mm_ops.matmul(a, b)
    torch.cuda.synchronize()
    assert mm_ops.launches == before + 1
    ref = matmul_ref(a, b).float()
    assert out.dtype == a.dtype and bool(torch.isfinite(out).all())
    rel = 2.0 ** -7 if dt == "bfloat16" else 1e-4
    assert float((out.float() - ref).abs().max()) <= \
        rel * float(ref.abs().max())


def test_matmul_native_equals_container_bound(cuda, tmp_path):
    """The fig5 pair: blocks named natively (``platform="h100"``) and
    resolved from the device of a container bound from an Imagefile give
    the same bits."""
    from repro_torch.core.runtime import Runtime
    rt = Runtime(tmp_path / "rt")
    rt.build("FROM scratch\nARCH llama3.2-3b-smoke\nMESH local\n"
             "PRECISION compute=float32 params=float32\n", tag="stable")
    device = rt.run("stable").device
    assert device.type == "cuda"
    for M, K, N, dt in ((256, 256, 256, "float32"),
                        (512, 3072, 8192, "bfloat16")):
        g = torch.Generator(device=device).manual_seed(0)
        a = torch.randn(M, K, generator=g, device=device).to(getattr(torch, dt))
        b = torch.randn(K, N, generator=g, device=device).to(getattr(torch, dt))
        assert torch.equal(mm_ops.matmul(a, b, platform="h100"),
                           mm_ops.matmul(a, b))


def test_moe_smoke_prefill_on_the_card_equals_the_cpu(cuda):
    """moonshot-v1-16b-a3b-smoke in float32, the same weights on both
    devices: the card's prefill (K2 in every attention layer, the MoE
    dispatch and expert products in PyTorch) equals the CPU's within 1e-4,
    aux within 1e-6, and K2 ran once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import materialize, tree_map
    from repro_torch.models.transformer import Model
    cfg = get_config("moonshot-v1-16b-a3b-smoke")
    m = Model(cfg, act_dtype=torch.float32)
    params = materialize(m.param_defs(), 0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    with torch.no_grad():
        cpu, cpu_aux = m.forward(params, toks)
        before = fa_ops.launches
        card, card_aux = m.forward(tree_map(lambda a: a.to(cuda), params),
                                   toks.to(cuda))
        torch.cuda.synchronize()
    assert fa_ops.launches == before + cfg.n_layers
    assert float((card.cpu() - cpu).abs().max()) <= 1e-4
    assert abs(float(card_aux) - float(cpu_aux)) <= 1e-6


@pytest.mark.parametrize("arch", ["llama3.2-3b-smoke",
                                  "recurrentgemma-2b-smoke"])
def test_whole_batch_on_the_card_equals_the_cpu(cuda, tmp_path, arch):
    """The whole-batch serve path in float32, the same weights on both
    devices: ``Container.prefill_fn()`` over 4 prompts of 40 tokens (K2 in
    every attention layer, K4 in every rec layer on the card), then 6
    ``decode_fn()`` steps at a 0-d position; greedy tokens identical, and
    no kernel launched during the lockstep decode."""
    from repro_torch.core.runtime import Runtime
    from repro_torch.serve.serve_step import greedy_sample
    rt = Runtime(tmp_path / "rt")
    rt.build(f"FROM scratch\nARCH {arch}\nSHAPE prefill_32k seq_len=64 "
             "global_batch=4\nMESH local\n"
             "PRECISION compute=float32 params=float32\n", tag="t")
    cpu = rt.run("t", platform="cpu")
    params = cpu.init_params(0)
    prompts = np.random.default_rng(0).integers(0, cpu.arch.vocab_size,
                                                (4, 40))
    tokens = {}
    for c in (cpu, rt.run("t")):
        p = c.load_params(params)
        before = (fa_ops.launches, rg_ops.launches)
        last, cache = c.prefill_fn()(p, torch.as_tensor(prompts,
                                                        device=c.device))
        tok = greedy_sample(last, c.arch.vocab_size)[:, None]
        after = (fa_ops.launches, rg_ops.launches)
        out = [tok[:, 0]]
        for i in range(6):
            logits, cache = c.decode_fn()(
                p, cache, tok, torch.tensor(40 + i, dtype=torch.int32,
                                            device=c.device))
            tok = greedy_sample(logits, c.arch.vocab_size)[:, None]
            out.append(tok[:, 0])
        tokens[c.device.type] = torch.stack(out, 1).tolist()
        if c.device.type == "cuda":
            torch.cuda.synchronize()
            kinds = c.arch.layer_types()
            assert after[0] - before[0] == kinds.count("attn")
            assert after[1] - before[1] == kinds.count("rec")
            assert (fa_ops.launches, rg_ops.launches) == after
    assert tokens["cuda"] == tokens["cpu"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_bf16_scores_on_the_card(cuda, dtype):
    """``attend`` with bfloat16 scores takes the chunked path on the card
    (chosen by dtype: no K2 launch) and equals the CPU within 3e-2, the
    bfloat16 tolerance of its CPU parity test against the JAX package
    (tests/test_torch_hygiene.py). Float32 inputs are held to it too: the
    card's float32 products round apart from the CPU's, and a score whose
    bfloat16 rounding flips moves the output by up to one bfloat16 step."""
    from repro_torch.models.attention import attend
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dt) for s in ((2, 40, 4, 32), (2, 40, 2, 32),
                                 (2, 40, 2, 32)))
    pos = torch.arange(40, dtype=torch.int32)[None]
    kw = dict(score_dtype=torch.bfloat16, q_chunk=16, kv_chunk=16)
    cpu = attend(q, k, v, pos, pos, **kw)
    before = fa_ops.launches
    card = attend(q.to(cuda), k.to(cuda), v.to(cuda), pos.to(cuda),
                  pos.to(cuda), **kw)
    torch.cuda.synchronize()
    assert fa_ops.launches == before
    assert float((card.cpu().float() - cpu.float()).abs().max()) <= 3e-2


# ---------------------------------------------------------------------------
# gradients: each kernel's torch.autograd.Function on the card against the
# plain version under autograd, a launch a forward (and for K2 and K4 one
# backward launch); K2's backward kernels against its plain backward
# ---------------------------------------------------------------------------

# the backward kernels' bound, relative to the largest plain gradient
BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}

GRAD_FA_CASES = [  # B, Hq, Hkv, S, d, window, dtype
    (1, 4, 2, 128, 64, 0, "bfloat16"),
    (2, 4, 1, 100, 128, 48, "bfloat16"),
    (1, 2, 2, 96, 32, 0, "float32"),
]


def _grad_pair(fn, plain, inputs, cot):
    xs = [t.detach().requires_grad_() for t in inputs]
    rs = [t.detach().requires_grad_() for t in inputs]
    out, ref = fn(*xs), plain(*rs)
    return (out.detach(), ref.detach(), torch.autograd.grad(out, xs, cot),
            torch.autograd.grad(ref, rs, cot))


def _bwd_close(got, want, dt):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        err = float((a.float() - b.float()).abs().max())
        assert err <= BWD_TOL[dt] * float(b.float().abs().max()), err


@pytest.mark.parametrize("case", GRAD_FA_CASES, ids=str)
def test_flash_attention_function_grads(case, cuda):
    """The Function's forward within the forward's tolerance of the plain
    version, its grads (the backward kernels) within the backward's of
    the dense float32 plain backward."""
    B, Hq, Hkv, S, d, window, dt = case
    rng = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda, getattr(torch, dt))
    q, k, v, cot = t(B, Hq, S, d), t(B, Hkv, S, d), t(B, Hkv, S, d), \
        t(B, Hq, S, d)
    before = fa_ops.launches, fa_ops.bwd_launches
    out, ref, g, gr = _grad_pair(
        lambda *x: fa_ops.flash_attention(*x, causal=True, window=window),
        lambda *x: flash_attention_ref(*x, causal=True, window=window),
        (q, k, v), cot)
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert out.dtype == ref.dtype
    assert float((out.float() - ref.float()).abs().max()) < _tol(dt)
    f = [x.float() for x in (q, k, v)]
    want = flash_attention_bwd_ref(
        *f, flash_attention_ref(*f, causal=True, window=window),
        flash_attention_lse_ref(*f[:2], causal=True, window=window),
        cot.float(), causal=True, window=window)
    _bwd_close(g, [w.to(x.dtype) for w, x in zip(want, gr)], dt)


def test_flash_backward_on_the_card_never_reaches_a_plain_version(
        cuda, monkeypatch):
    """K2's Function forward and backward with its plain versions made to
    raise: a forward launch and one backward launch, nothing else."""
    def plain(*a, **kw):
        raise AssertionError("a plain version ran on the card")
    for name in ("flash_attention_ref", "_out_lse_ref",
                 "flash_attention_bwd_ref"):
        monkeypatch.setattr(fa_ops, name, plain)
    q = torch.randn(1, 4, 64, 32, device=cuda).requires_grad_()
    kv = torch.randn(1, 2, 64, 32, device=cuda).requires_grad_()
    before = fa_ops.launches, fa_ops.bwd_launches
    fa_ops.flash_attention(q, kv, kv).sum().backward()
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert all(torch.isfinite(x.grad).all() for x in (q, kv))


# B, Hq, Hkv, Sq, Sk, d, causal, window, dtype: every head dim in both
# dtypes, GQA groups 1-8 and recurrentgemma-2b's 10/1 (the dK/dV grid
# split over the group, float32 partials summed in order), windows,
# Sk > Sq suffixes, ragged lengths, a bidirectional case, rows that see no
# key (Sk < Sq), and the training shapes' widths
FA_BWD_CASES = [
    (1, 4, 2, 40, 40, 16, True, 0, "float32"),
    (1, 4, 2, 40, 40, 16, True, 0, "bfloat16"),
    (2, 8, 1, 96, 96, 32, True, 0, "float32"),
    (2, 8, 1, 96, 96, 32, True, 0, "bfloat16"),
    (1, 4, 4, 128, 256, 64, True, 64, "float32"),
    (1, 4, 4, 128, 256, 64, True, 64, "bfloat16"),
    (1, 6, 2, 100, 137, 80, True, 0, "float32"),
    (1, 6, 2, 100, 137, 80, True, 0, "bfloat16"),
    (1, 24, 8, 128, 328, 128, True, 0, "float32"),
    (1, 24, 8, 128, 328, 128, True, 0, "bfloat16"),
    (2, 10, 1, 100, 137, 256, True, 48, "float32"),
    (2, 10, 1, 100, 137, 256, True, 48, "bfloat16"),
    (1, 8, 2, 64, 64, 64, True, 0, "bfloat16"),        # group 4
    (1, 5, 1, 72, 72, 64, True, 0, "float32"),         # group 5
    (1, 12, 2, 64, 64, 128, True, 24, "bfloat16"),     # group 6
    (1, 7, 1, 80, 80, 32, True, 16, "float32"),        # group 7
    (1, 2, 2, 128, 128, 128, False, 0, "bfloat16"),    # bidirectional
    (1, 2, 2, 128, 128, 128, False, 0, "float32"),
    (1, 2, 1, 64, 40, 32, True, 0, "bfloat16"),        # 24 rows see nothing
    (1, 2, 1, 64, 40, 32, True, 0, "float32"),
    (2, 24, 8, 512, 512, 128, True, 0, "bfloat16"),    # llama3.2-3b's widths
    (1, 10, 1, 2048, 2048, 256, True, 2048, "bfloat16"),  # recurrentgemma
    (1, 10, 1, 2048, 2048, 256, True, 2048, "float32"),
    # bf16 at d 128 and 64: the TMA + wgmma kernels (128-key blocks, 64-row
    # query steps, 128-row dQ blocks): Sk - Sq = 37, ragged Sq = 1000, a
    # window of 300 over GQA 12/4, d 64 over 6/2
    (1, 8, 2, 219, 256, 128, True, 0, "bfloat16"),
    (1, 8, 2, 1000, 1000, 128, True, 0, "bfloat16"),
    (1, 12, 4, 1024, 1024, 128, True, 300, "bfloat16"),
    (2, 6, 2, 512, 512, 64, True, 0, "bfloat16"),
]


def _bwd_inputs(case, cuda, seed=11):
    B, Hq, Hkv, Sq, Sk, d, causal, window, dt = case
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda, getattr(torch, dt))
    q, k, v, do = t(B, Hq, Sq, d), t(B, Hkv, Sk, d), t(B, Hkv, Sk, d), \
        t(B, Hq, Sq, d)
    out, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, causal=causal,
                                               window=window, lse=True)
    return q, k, v, out, lse, do, dict(causal=causal, window=window)


@pytest.mark.parametrize("case", FA_BWD_CASES, ids=str)
def test_flash_backward_kernel_vs_plain(case, cuda):
    """The backward kernels against the dense plain backward on the same
    q, k, v, out, L and dO (the forward kernel's out and L, L itself
    against the plain log-sum-exp), one backward launch a call."""
    dt = case[-1]
    q, k, v, out, lse, do, kw = _bwd_inputs(case, cuda)
    want_lse = flash_attention_lse_ref(q, k, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    assert float((lse[fin] - want_lse[fin]).abs().max()) <= 1e-4 * max(
        1.0, float(want_lse[fin].abs().max()))
    before = fa_ops.launches, fa_ops.bwd_launches
    got = fa_ops.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.bwd_launches) == (before[0],
                                                      before[1] + 1)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    _bwd_close(got, want, dt)


@pytest.mark.parametrize("case", [FA_BWD_CASES[11], FA_BWD_CASES[10],
                                  FA_BWD_CASES[20], FA_BWD_CASES[25]],
                         ids=str)
def test_flash_backward_same_bits_twice(case, cuda):
    """No atomics: two calls give the same bits, with the group split
    (10/1) and without (24/8), on the mma.sync, FMA and wgmma routes."""
    q, k, v, out, lse, do, kw = _bwd_inputs(case, cuda)
    a = fa_ops.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    b = fa_ops.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_backward_key_block_and_route(cuda):
    """The .cu's getters: bf16 at d 64 and 128 runs the wgmma kernels on
    128-key blocks, at every other head dim mma.sync on 64; float32 the
    FMA kernels on 32."""
    for d in fa_ops.HEAD_DIMS:
        wg = d in (64, 128)
        assert fa_ops.bwd_key_block(torch.bfloat16, d) == (128 if wg else 64)
        assert fa_ops.bwd_route(torch.bfloat16, d) == (
            "wgmma" if wg else "mma.sync")
        assert fa_ops.bwd_key_block(torch.float32, d) == 32
        assert fa_ops.bwd_route(torch.float32, d) == "fma"


@pytest.mark.parametrize("case", [c for c in FA_CASES if c[0] * c[1] < 64],
                         ids=str)
def test_flash_forward_out_same_bits_with_and_without_lse(case, cuda):
    """Writing L changes nothing of the forward's output."""
    B, Hq, Hkv, Sq, Sk, d, causal, window, dt = case
    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda, getattr(torch, dt))
    q, k, v = t(B, Hq, Sq, d), t(B, Hkv, Sk, d), t(B, Hkv, Sk, d)
    kw = dict(causal=causal, window=window)
    out = fa_ops.flash_attention_fwd_cuda(q, k, v, **kw)
    out2, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, lse=True, **kw)
    assert torch.equal(out, out2) and lse.shape == (B, Hq, Sq)


def test_rglru_scan_function_grads(cuda):
    a, b = _rg_inputs((2, 300, 2560), cuda, seed=8)
    cot = _rg_inputs((2, 300, 2560), cuda, seed=9)[1]
    before = rg_ops.launches, rg_ops.bwd_launches
    h, ref, g, gr = _grad_pair(rg_ops.rglru_scan, rglru_scan_ref, (a, b),
                               cot)
    torch.cuda.synchronize()
    assert (rg_ops.launches, rg_ops.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert _rg_close(h, ref)
    for x, y in zip(g, gr):
        assert _rg_close(x, y)


def test_rglru_backward_on_the_card_never_reaches_a_plain_version(
        cuda, monkeypatch):
    """K4's Function forward and backward with its plain version made to
    raise: a forward launch and one reverse launch, nothing else."""
    def plain(*a, **kw):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(rg_ops, "rglru_scan_ref", plain)
    a = torch.rand(1, 64, 256, device=cuda).requires_grad_()
    b = torch.randn(1, 64, 256, device=cuda).requires_grad_()
    before = rg_ops.launches, rg_ops.bwd_launches
    rg_ops.rglru_scan(a, b).sum().backward()
    torch.cuda.synchronize()
    assert (rg_ops.launches, rg_ops.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert all(torch.isfinite(x.grad).all() for x in (a, b))


@pytest.mark.parametrize("shape", [(2, 300, 2560), (1, 2048, 2560),
                                   (2, 33, 31), (1, 10, 2563)], ids=str)
def test_rglru_reverse_scan_vs_plain(shape, cuda):
    """K4's backward recurrence, one reverse launch: within the scan's
    tolerance of the plain reverse scan, and bit for bit the forward kernel
    on flipped copies."""
    a, g = _rg_inputs(shape, cuda, seed=13)
    before = rg_ops.launches, rg_ops.bwd_launches
    dh = rg_ops.rglru_scan_cuda(a, g, reverse=True)
    torch.cuda.synchronize()
    assert (rg_ops.launches, rg_ops.bwd_launches) == (before[0],
                                                      before[1] + 1)
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    assert _rg_close(dh, rglru_scan_ref(a_next.flip(1), g.flip(1)).flip(1))
    assert torch.equal(dh, rg_ops.rglru_scan_cuda(
        a_next.flip(1).contiguous(), g.flip(1).contiguous()).flip(1))


def test_ssd_function_grads(cuda):
    rng = np.random.default_rng(10)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)  # noqa: E731
    b, S, H, P, N, Q = 1, 256, 8, 64, 128, 64
    x = t(rng.standard_normal((b, S, H, P)))
    dt = t(np.log1p(np.exp(rng.standard_normal((b, S, H)) - 1.0)))
    A = t(-np.exp(0.5 * rng.standard_normal(H)))
    B, C = t(rng.standard_normal((b, S, N))), t(rng.standard_normal((b, S, N)))
    cot = t(rng.standard_normal((b, S, H, P)))
    before = ssd_ops.launches, ssd_ops.bwd_launches
    y, ref, g, gr = _grad_pair(lambda *z: ssd_ops.ssd(*z, Q)[0],
                               lambda *z: _ssd_chunked(*z, Q)[0],
                               (x, dt, A, B, C), cot)
    torch.cuda.synchronize()
    assert (ssd_ops.launches, ssd_ops.bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
    for u, w in ((y, ref), *zip(g, gr)):
        assert float((u - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _ssd_bwd_inputs(case, cuda, seed=12, A=None, tail=0, state=True):
    """x, dt, A, B, C, gy and gstate on the card; ``A`` fixes every
    head's decay, ``tail`` zeroes the last positions' x, dt, B, C and gy
    as ssm_forward pads a sequence, ``state`` draws gstate (else None)."""
    b, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H))))
    B, C = rng.standard_normal((b, S, N)), rng.standard_normal((b, S, N))
    gy = rng.standard_normal((b, S, H, P))
    for a in (x, dt, B, C, gy):
        a[:, S - tail:] = 0
    A = -np.exp(0.5 * rng.standard_normal(H)) if A is None else np.full(H, A)
    gs = rng.standard_normal((b, H, N, P)) if state else None
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)  # noqa: E731
    return [t(a) for a in (x, dt, A, B, C, gy)] + [
        None if gs is None else t(gs)]


# SSD_CASES, then a decay that drives exponents past the clip at -60
# inside a chunk, and a zero tail of 40 and of 100 positions (a padded
# mamba2 sequence, the final state unused)
SSD_BWD_CASES = [(case, {}) for case in SSD_CASES] + [
    ((2, 64, 2, 16, 8, 32), {"A": -8.0}),
    ((1, 256, 4, 64, 128, 128), {"A": -8.0}),
    ((1, 256, 8, 64, 128, 64), {"tail": 40}),
    ((1, 512, 8, 64, 128, 256), {"tail": 100, "state": False})]


@pytest.mark.parametrize("case,kw", SSD_BWD_CASES, ids=str)
def test_ssd_backward_kernel_vs_plain(case, kw, cuda):
    """K5's backward kernels: every grad within 1e-4 of the largest of
    the plain backward on the same inputs, one ``bwd_launches`` a call
    and no forward launch, the same bits from two calls."""
    *ins, gy, gs = _ssd_bwd_inputs(case, cuda, **kw)
    Q = case[-1]
    before = ssd_ops.launches, ssd_ops.bwd_launches
    got = ssd_ops.ssd_bwd_cuda(*ins, Q, gy, gs)
    torch.cuda.synchronize()
    assert (ssd_ops.launches, ssd_ops.bwd_launches) == (before[0],
                                                        before[1] + 1)
    again = ssd_ops.ssd_bwd_cuda(*ins, Q, gy, gs)
    want = ssd_bwd_ref(*ins, Q, gy, gs)
    for a, c, w in zip(got, again, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all())
        assert torch.equal(a, c)
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_ssd_backward_on_the_card_never_reaches_a_plain_version(
        cuda, monkeypatch):
    """K5's Function forward and backward with its plain versions made
    to raise: a forward launch and one backward launch, nothing else; a
    final state that nothing uses gets no cotangent."""
    def plain(*a, **kw):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(ssd_ops, "_ssd_chunked", plain)
    monkeypatch.setattr(ssd_ops, "ssd_bwd_ref", plain)
    *ins, gy, _ = _ssd_bwd_inputs((1, 256, 8, 64, 128, 64), cuda,
                                  state=False)
    xs = [t.requires_grad_() for t in ins]
    before = ssd_ops.launches, ssd_ops.bwd_launches
    y, _ = ssd_ops.ssd(*xs, 64)
    (y * gy).sum().backward()
    torch.cuda.synchronize()
    assert (ssd_ops.launches, ssd_ops.bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert all(bool(torch.isfinite(x.grad).all()) for x in xs)


def test_two_gloo_ranks_on_the_card_equal_the_cpu(cuda, tmp_path):
    """llama3.2-3b-smoke in float32 on two gloo ranks that share cuda:0
    (tests/torch_dist_worker.py; gloo's collectives go through host
    memory), generic and ZeRO-1: every step's loss and grad_norm equal one
    CPU process's on the same global batches within 1e-3 relative (the
    card's kernels sum in other orders; chip_smoke's card-vs-CPU bound),
    and each rank launched the flash-attention kernel once a layer a
    step."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.checkpoint.store import _flatten, _unflatten
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    image = ("FROM scratch\nARCH llama3.2-3b-smoke\nSHAPE train_4k "
             "seq_len=64 global_batch=4\nMESH local\nPRECISION "
             "compute=float32 params=float32\nCOLLECTIVES {}\nSET "
             'optimizer={{"lr":0.005,"warmup_steps":2,"total_steps":50}}\n')
    plan = {"steps": 3, "abis": {"generic": image.format("generic"),
                                 "host": image.format("host")}}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    rt = Runtime(tmp_path / "cpu")
    c = rt.run(rt.build(plan["abis"]["generic"]), platform="cpu")
    weights = c.init_params(0)
    np.savez(tmp_path / "params.npz", **{
        k: v.numpy() for k, v in _flatten(weights)})
    data = SyntheticLM(DataConfig(vocab_size=c.arch.vocab_size, seq_len=64,
                                  global_batch=4, seed=3))
    for i in range(3):
        np.savez(tmp_path / f"batch{i}.npz", **data.batch(i))
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, str(root / "tests" / "torch_dist_worker.py"),
         "card2", str(r), "2", str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[-2000:] for o in outs]
    card = json.loads((tmp_path / "card2.json").read_text())["abis"]
    for name, imagefile in plan["abis"].items():
        c = rt.run(rt.build(imagefile), platform="cpu")
        params = c.load_params(_unflatten(c.param_defs, dict(
            _flatten(weights))))
        opt, step = c.init_opt_state(params), c.train_step_fn()
        run = card[name]
        assert run["device"] == "cuda:0" and run["backend"] == "gloo"
        assert run["k2"] == c.arch.n_layers * 3
        for i, rec in enumerate(run["steps"]):
            params, opt, m = step(params, opt, data.batch(i))
            for key in ("loss", "grad_norm"):
                want = float(m[key])
                assert abs(rec[key] - want) <= 1e-3 * abs(want), (name, i,
                                                                 key)
