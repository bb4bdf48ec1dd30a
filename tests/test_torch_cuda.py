"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and skips without one (the kernels
have no CPU mode). The file imports neither jax nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: 1e-4 in float32 (the kernel sums in another order), 3e-2 in
bfloat16 (as the JAX kernel suites).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

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
]


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
    lengths = np.concatenate([[1, mp * ps],
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
    # the single-pass kernel (no split, no merge) computes the same
    one = pa_ops.paged_attention_cuda(*args, window=window, n_split=1)
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
