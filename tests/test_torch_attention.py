"""The port's attention kernels and their plain versions against the JAX
package, on the CPU; the CUDA kernels against the plain versions on a card.

* K1 (paged decode): the plain version (``repro_torch...paged_attention.ref``)
  against the JAX oracle and the Pallas kernel run in interpret mode, over
  the JAX suite's ``PA_CASES``, page sizes 8/16/64 and garbage poisoning.
  Tolerance 3e-5 in f32, 3e-2 in bf16 (as tests/test_paged_attention.py).
* K2 (flash forward): the plain version against the JAX oracle and the
  interpreted Pallas ``flash_attention_fwd`` over ``FA_CASES``, plus a
  ragged suffix case against ``attend(q_offset=...)``.
* The CUDA kernels themselves are held against these plain versions on a
  card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.paged_attention.kernel import paged_attention_pallas
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.models.attention import attend as j_attend
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref as t_flash_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_ref as t_paged_ref
from repro_torch.models.attention import attend as t_attend

PA_CASES = [
    # B, n_kv, g, hd, page_size, max_pages, window, dtype
    (4, 2, 2, 16, 8, 4, 0, "float32"),
    (3, 1, 8, 32, 16, 3, 0, "float32"),      # MQA
    (2, 4, 1, 64, 64, 2, 0, "float32"),      # MHA, big pages
    (4, 2, 3, 16, 8, 6, 12, "float32"),      # sliding window
    (2, 2, 2, 32, 16, 4, 0, "bfloat16"),
    (2, 1, 4, 64, 64, 3, 40, "bfloat16"),    # window + big pages
]

FA_CASES = [
    # B, Hq, Hkv, Sq, Sk, d, causal, window, dtype
    (2, 4, 2, 128, 128, 64, True, 0, "float32"),
    (1, 8, 1, 256, 256, 32, True, 0, "float32"),     # MQA
    (2, 4, 4, 128, 256, 64, True, 64, "float32"),    # window + kv>q
    (1, 2, 2, 128, 128, 128, False, 0, "float32"),   # bidirectional
    (1, 4, 2, 256, 256, 64, True, 0, "bfloat16"),
    (1, 2, 1, 64, 192, 128, True, 128, "bfloat16"),
]


def _tol(dt):
    return 3e-2 if dt == "bfloat16" else 3e-5


def _err(j, t):
    return float(np.abs(np.asarray(j, np.float32)
                        - t.detach().float().numpy()).max())


def _both(a, dt):
    """numpy f32 -> (jax array, torch tensor), both in dtype ``dt``."""
    return jnp.asarray(a, getattr(jnp, dt)), torch.from_numpy(a).to(
        getattr(torch, dt))


def _random_paged(rng, B, n_kv, g, hd, ps, mp, lengths):
    """Random pool + a scattered (shuffled) allocation, as numpy."""
    n_alloc = sum(-(-int(l) // ps) for l in lengths)
    n_pages = n_alloc + 3                       # garbage page 0 + 2 spare
    free = list(range(1, n_pages))
    rng.shuffle(free)
    table = np.zeros((B, mp), np.int32)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // ps)):
            table[b, j] = free.pop()
    q = rng.standard_normal((B, n_kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((n_kv, n_pages, ps, hd)).astype(np.float32)
    v = rng.standard_normal((n_kv, n_pages, ps, hd)).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, np.int32)


# ---------------------------------------------------------------------------
# K1: paged decode
# ---------------------------------------------------------------------------

def _pa_inputs(case):
    B, n_kv, g, hd, ps, mp, window, dt = case
    rng = np.random.default_rng(42)
    lengths = np.concatenate([[1, mp * ps],
                              rng.integers(1, mp * ps, max(0, B - 2))])
    lengths = lengths[:B].astype(np.int32)
    return _random_paged(rng, B, n_kv, g, hd, ps, mp, lengths), window, dt


@pytest.mark.parametrize("case", PA_CASES, ids=str)
def test_paged_plain_vs_jax_oracle_and_pallas(case):
    (q, k, v, table, lens), window, dt = _pa_inputs(case)
    jq, tq = _both(q, dt)
    jk, tk = _both(k, dt)
    jv, tv = _both(v, dt)
    out = pa_ops.paged_attention(tq, tk, tv, torch.from_numpy(table),
                                 torch.from_numpy(lens), window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    ref = paged_attention_ref(jq, jk, jv, jnp.asarray(table),
                              jnp.asarray(lens), window=window)
    pal = paged_attention_pallas(jq, jk, jv, jnp.asarray(table),
                                 jnp.asarray(lens), window=window,
                                 interpret=True)
    assert _err(ref.astype(jnp.float32), out) < _tol(dt)
    assert _err(pal.astype(jnp.float32), out) < _tol(dt)


@pytest.mark.parametrize("page_size", [8, 16, 64])
def test_paged_page_size_is_pure_layout(page_size):
    """The same logical KV history attends identically however it is cut
    into pages, and equals the contiguous ``attend`` of both packages."""
    rng = np.random.default_rng(0)
    B, n_kv, g, hd, L = 3, 2, 2, 32, 128
    lengths = np.array([1, 70, 128], np.int32)
    kc = rng.standard_normal((B, L, n_kv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, L, n_kv, hd)).astype(np.float32)
    q = rng.standard_normal((B, n_kv * g, hd)).astype(np.float32)
    mp = L // page_size
    n_pages = B * mp + 1
    perm = list(range(1, n_pages))
    rng.shuffle(perm)
    table = np.zeros((B, mp), np.int32)
    k_pages = np.zeros((n_kv, n_pages, page_size, hd), np.float32)
    v_pages = np.zeros((n_kv, n_pages, page_size, hd), np.float32)
    for b in range(B):
        for j in range(mp):
            p = perm.pop()
            table[b, j] = p
            sl = slice(j * page_size, (j + 1) * page_size)
            k_pages[:, p] = kc[b, sl].transpose(1, 0, 2)
            v_pages[:, p] = vc[b, sl].transpose(1, 0, 2)
    q_pos = (lengths - 1)[:, None]
    k_pos = np.broadcast_to(np.arange(L), (B, L))
    ref_c = j_attend(jnp.asarray(q)[:, None], jnp.asarray(kc),
                     jnp.asarray(vc), jnp.asarray(q_pos),
                     jnp.asarray(k_pos))[:, 0]
    t_c = t_attend(torch.from_numpy(q)[:, None], torch.from_numpy(kc),
                   torch.from_numpy(vc), torch.from_numpy(q_pos),
                   torch.from_numpy(np.ascontiguousarray(k_pos)))[:, 0]
    out = pa_ops.paged_attention(*(torch.from_numpy(a) for a in
                                   (q, k_pages, v_pages, table, lengths)))
    assert _err(ref_c, out) < 3e-5
    assert _err(ref_c, t_c) < 3e-5
    # the port's own paged and contiguous paths agree to rounding
    assert float((out - t_c).abs().max()) < 1e-6


def test_paged_unmapped_pages_and_garbage_are_invisible():
    """Poisoning the garbage page and every unallocated page changes no
    output: the mask, not the allocator, hides junk."""
    rng = np.random.default_rng(1)
    B, n_kv, g, hd, ps, mp = 3, 2, 2, 16, 8, 5
    lengths = np.array([3, 17, 26], np.int32)
    q, k, v, table, lens = _random_paged(rng, B, n_kv, g, hd, ps, mp, lengths)
    t = torch.from_numpy
    base = pa_ops.paged_attention(t(q), t(k), t(v), t(table), t(lens))
    used = np.unique(table)
    kp, vp = k.copy(), v.copy()
    # every unallocated page AND the garbage page 0 that unmapped entries hit
    unused = np.union1d(np.setdiff1d(np.arange(k.shape[1]), used), [0])
    kp[:, unused] = 1e9
    vp[:, unused] = 1e9
    poisoned = pa_ops.paged_attention(t(q), t(kp), t(vp), t(table), t(lens))
    assert torch.equal(base, poisoned)
    jref = paged_attention_ref(*(jnp.asarray(a) for a in
                                 (q, kp, vp, table, lens)))
    assert _err(jref, poisoned) < 3e-5


def test_paged_ops_cpu_dispatch_is_the_plain_version():
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(a) for a in _random_paged(
        rng, 2, 2, 2, 16, 8, 2, np.array([5, 9]))]
    before = pa_ops.launches
    assert torch.equal(pa_ops.paged_attention(*args), t_paged_ref(*args))
    assert pa_ops.launches == before           # CPU calls are not launches


# ---------------------------------------------------------------------------
# K2: flash forward
# ---------------------------------------------------------------------------

def _fa_inputs(case, seed=0):
    B, Hq, Hkv, Sq, Sk, d, causal, window, dt = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, d)).astype(np.float32)
    return q, k, v, causal, window, dt


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_plain_vs_jax_oracle_and_pallas(case):
    q, k, v, causal, window, dt = _fa_inputs(case)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dt) for a in (q, k, v))
    out = fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    ref = flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    pal = flash_attention_fwd(jq, jk, jv, causal=causal, window=window,
                              block_q=64, block_k=64, interpret=True)
    assert _err(ref.astype(jnp.float32), out) < _tol(dt)
    assert _err(pal.astype(jnp.float32), out) < _tol(dt)


@pytest.mark.parametrize("prefix", [200, 64])
def test_flash_suffix_case_matches_attend_with_offset(prefix):
    """Ragged suffix prefill: Sq = 48 queries after a ``prefix``-long cached
    history (Sk = prefix + 48, tiling neither 64 nor 128). The flash plain
    version with its Sk - Sq offset equals the JAX ``attend`` at
    q_offset = prefix, and the port's ``attend`` on the same layout."""
    B, Hq, Hkv, Sq, d = 1, 6, 2, 48, 32
    Sk = prefix + Sq
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, Sq, Hq, d)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, d)).astype(np.float32)
    q_pos = (prefix + np.arange(Sq, dtype=np.int32))[None]
    k_pos = np.arange(Sk, dtype=np.int32)[None]
    ref = j_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(q_pos), jnp.asarray(k_pos), q_offset=prefix)
    t = torch.from_numpy
    fl = fa_ops.flash_attention(t(q).transpose(1, 2).contiguous(),
                                t(k).transpose(1, 2).contiguous(),
                                t(v).transpose(1, 2).contiguous(),
                                causal=True).transpose(1, 2)
    assert _err(ref, fl) < 3e-5
    at = t_attend(t(q), t(k), t(v), t(q_pos), t(k_pos), q_offset=prefix)
    assert _err(ref, at) < 3e-5


def test_attend_chunked_path_matches_jax():
    """The plain path's online-softmax branch (bf16 score chain) against
    the JAX package's, at a small chunk size so several chunks and the
    causal skip are exercised."""
    B, S, Hq, Hkv, d = 1, 24, 4, 2, 16
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((B, S, h, d)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    pos = np.arange(S, dtype=np.int32)[None]
    ref = j_attend(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                   score_dtype=jnp.bfloat16, q_chunk=16, kv_chunk=8)
    t = torch.from_numpy
    out = t_attend(t(q), t(k), t(v), t(pos), t(pos),
                   score_dtype=torch.bfloat16, q_chunk=16, kv_chunk=8)
    assert _err(ref, out) < 3e-2


def test_flash_ops_cpu_dispatch_is_the_plain_version():
    q, k, v, causal, window, _ = _fa_inputs(FA_CASES[0], seed=3)
    t = torch.from_numpy
    before = fa_ops.launches
    assert torch.equal(fa_ops.flash_attention(t(q), t(k), t(v)),
                       t_flash_ref(t(q), t(k), t(v)))
    assert fa_ops.launches == before
