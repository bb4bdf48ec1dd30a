"""The pure functions that plan the port's CUDA launches, held without a
card: K1's span plan (which block covers which positions) and its kernel
choice, K4's tile plan (and its look-back algebra, emulated in numpy),
K5's P slice and scratch shapes, and K2's ``wgmma`` forward plan (the key
tiles each query tile sees and those a mask edge crosses), held by brute
force to the JAX kernel's own mask. They decide before a launch, from
shapes alone, what the kernels in ``repro_torch/csrc`` then do, so a wrong
plan shows here on the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssd import ops as ssd_ops

H100_SMS = 132

# (lengths, window, page size, table width): ragged slots, a 1-token and a
# full slot, windows inside one page and across spans, pages that do not
# divide the span, and an empty slot
PLAN_CASES = [
    ([1, 2048, 700, 33, 1024, 129, 5, 1999], 0, 16, 129),
    ([1, 2048, 700, 33, 1024, 129, 5, 1999], 200, 16, 129),
    ([64, 544, 300, 128, 129, 400, 512, 65], 0, 16, 64),
    ([10, 40, 17], 12, 8, 6),
    ([0, 1, 120], 0, 24, 5),
    ([90, 91, 7], 30, 24, 5),
    ([200, 1], 0, 64, 4),
]


def _live(length: int, window: int, ps: int, mp: int) -> range:
    lo = max(0, length - window) if window > 0 else 0
    return range(lo, min(length, mp * ps))


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
@pytest.mark.parametrize("B_kv", [(8, 8), (1, 2), (64, 8)], ids=str)
def test_k1_span_plan_covers_each_live_position_once(case, B_kv):
    lengths, window, ps, mp = case
    B, n_kv = B_kv
    sp = pa_ops.span_pages(B, n_kv, mp, ps, H100_SMS)
    assert 1 <= sp <= mp
    span_tok = sp * ps
    plan = pa_ops.span_ranges(lengths, window, ps, mp, sp)
    assert len(plan) == len(lengths)
    for length, blocks in zip(lengths, plan):
        covered = []
        spans = [s for s, _, _ in blocks]
        assert len(spans) == len(set(spans))          # one range a block
        for s, first, end in blocks:
            assert 0 <= s < -(-mp // sp)
            assert s * span_tok <= first < end <= (s + 1) * span_tok
            covered.extend(range(first, end))
        assert sorted(covered) == list(_live(length, window, ps, mp))


def test_k1_span_pages_from_shapes():
    # llama3.2-3b decode at the kernel record's table (129 pages): 256-token
    # spans, 9 spans, 576 blocks for 132 SMs
    assert pa_ops.span_pages(8, 8, 129, 16, H100_SMS) == 16
    # the llama pod's table (1024 / 16 pages) halves to 128-token spans
    assert pa_ops.span_pages(8, 8, 64, 16, H100_SMS) == 8
    # pages longer than the span: one page a block
    assert pa_ops.span_pages(8, 8, 16, 256, H100_SMS) == 1
    for B, n_kv, mp, ps in ((8, 8, 129, 16), (1, 8, 257, 16), (64, 8, 64, 16),
                            (2, 1, 5, 24)):
        sp = pa_ops.span_pages(B, n_kv, mp, ps, H100_SMS)
        blocks = B * n_kv * -(-mp // sp)
        assert sp == 1 or blocks >= pa_ops.MIN_BLOCKS_PER_SM * H100_SMS
        assert sp * ps <= max(ps, pa_ops.SPAN_TOKENS)


@pytest.mark.parametrize("dtype,g,hd,want", [
    (torch.bfloat16, 3, 128, ("mma", 128)),
    (torch.bfloat16, 16, 16, ("mma", 16)),
    (torch.bfloat16, 3, 256, ("fma", 3)),
    (torch.float32, 3, 128, ("fma", 3)),
    (torch.float32, 6, 64, ("fma", 16)),
    (torch.float32, 8, 32, ("fma", 8)),
])
def test_k1_kernel_choice(dtype, g, hd, want):
    assert pa_ops.kernel_choice(dtype, g, hd) == want


def test_k1_plan_matches_the_plain_version_on_the_cpu():
    """The positions the plan covers are the positions the plain version
    attends to: attention restricted to them (one block each) and merged
    equals the reference."""
    rng = np.random.default_rng(0)
    n_kv, g, hd, ps, mp = 2, 3, 16, 8, 6
    lengths = np.array([1, 48, 30], np.int32)
    window = 20
    pool = rng.standard_normal((n_kv, 1 + mp * 3, ps, hd)).astype(np.float32)
    table = 1 + np.arange(3 * mp, dtype=np.int32).reshape(3, mp)
    q = torch.from_numpy(rng.standard_normal((3, n_kv * g, hd)).astype(
        np.float32))
    k = torch.from_numpy(pool)
    v = torch.from_numpy(pool[:, ::-1].copy())
    ref = pa_ops.paged_attention(q, k, v, torch.from_numpy(table),
                                 torch.from_numpy(lengths), window=window)
    sp = pa_ops.span_pages(3, n_kv, mp, ps, H100_SMS)
    plan = pa_ops.span_ranges(lengths, window, ps, mp, sp)
    for b, blocks in enumerate(plan):
        keys = torch.cat([k[:, table[b, p // ps], p % ps][:, None]
                          for _, first, end in blocks
                          for p in range(first, end)], dim=1)
        vals = torch.cat([v[:, table[b, p // ps], p % ps][:, None]
                          for _, first, end in blocks
                          for p in range(first, end)], dim=1)
        qb = q[b].reshape(n_kv, g, hd)
        w = torch.softmax(qb @ keys.transpose(1, 2) / hd ** 0.5, dim=-1)
        out = (w @ vals).reshape(n_kv * g, hd)
        assert torch.allclose(out, ref[b], atol=1e-5)


@pytest.mark.parametrize("P,want", [(16, 16), (32, 32), (48, 64), (64, 64),
                                    (96, 128), (128, 128), (144, 128)])
def test_k5_p_tile(P, want):
    assert ssd_ops.p_tile(P) == want


def test_k5_scratch_shapes():
    # mamba2-2.7b's 512-token prefill: two chunks of 256
    assert ssd_ops.scratch_shapes(1, 512, 80, 64, 128, 256) == {
        "scores": (2, 256, 256), "cum": (2, 80, 256),
        "states": (2, 80, 128, 64), "prev": (2, 80, 128, 64)}
    # a ragged chunk: score rows padded to the kernel's 32-column k tiles
    assert ssd_ops.scratch_shapes(2, 200, 3, 32, 48, 100)["scores"] == \
        (4, 100, 128)


# K4 shapes (B, S, R): one step, the recurrentgemma pod's prefills (64 and
# 512 tokens, 2304 past the window) at R 2560, a batch of three, ragged S
# and R (not multiples of a tile's steps or 32 channels), and tiny ones
RG_PLAN_SHAPES = [(1, 1, 2560), (1, 64, 2560), (1, 512, 2560),
                  (1, 2304, 2560), (3, 2304, 2560), (3, 100, 2560),
                  (1, 100, 200), (2, 33, 31), (1, 7, 1), (4, 1000, 96)]


@pytest.mark.parametrize("shape", RG_PLAN_SHAPES, ids=str)
def test_k4_plan_covers_every_step_and_channel_once(shape):
    B, S, R = shape
    plan = rg_ops.scan_plan(B, S, R, H100_SMS)
    assert plan == rg_ops.scan_plan(B, S, R, H100_SMS)      # shapes only
    assert plan.steps in rg_ops.STEPS
    assert plan.T == rg_ops.WARPS * plan.steps
    # the slabs and chunks cover R and S, the last one ragged at most
    assert (plan.n_slabs - 1) * rg_ops.CHANNELS < R <= \
        plan.n_slabs * rg_ops.CHANNELS
    assert (plan.n_chunks - 1) * plan.T < S <= plan.n_chunks * plan.T
    assert plan.n_tiles == B * plan.n_slabs * plan.n_chunks
    # tile = ticket: chunk-major, (batch, slab) columns fastest; each
    # (b, t, r) belongs to exactly one tile, warp and lane
    n_cols = B * plan.n_slabs
    seen = np.zeros((B, S, R), np.int32)
    for tile in range(plan.n_tiles):
        k, col = divmod(tile, n_cols)
        b, slab = divmod(col, plan.n_slabs)
        t = slice(k * plan.T, min(S, (k + 1) * plan.T))
        r = slice(slab * rg_ops.CHANNELS, min(R, (slab + 1) * rg_ops.CHANNELS))
        seen[b, t, r] += 1
        if k:                        # its predecessor took an earlier ticket
            assert tile - n_cols >= 0
    assert (seen == 1).all()


@pytest.mark.parametrize("S", [64, 512, 2304])
def test_k4_plan_fills_the_card_at_the_pods_prefills(S):
    B, R = 1, 2560
    plan = rg_ops.scan_plan(B, S, R, H100_SMS)
    assert plan.n_tiles >= H100_SMS                  # every SM gets a block
    # and the tiles are the longest that still do
    for st in rg_ops.STEPS:
        if st > plan.steps:
            longer = B * plan.n_slabs * -(-S // (rg_ops.WARPS * st))
            assert longer < H100_SMS
    assert plan.steps == {64: 4, 512: 16, 2304: 16}[S]


@pytest.mark.parametrize("R", [2560, 2563])
def test_k4_plan_reaches_every_compiled_tile(R):
    """tests/test_torch_cuda.py's RG_TILE_SHAPES launch every tile length
    the kernel is compiled for, each from the plan's own choice."""
    steps = [rg_ops.scan_plan(1, S, R, H100_SMS).steps
             for S in (10, 20, 40, 100, 300)]
    assert steps == list(rg_ops.STEPS)


def _lookback_scan(a, b, plan):
    """The kernel's arithmetic, tile by tile in ticket order: per-warp
    pairs, the tile aggregate, the look-back (the inclusive prefix of the
    nearest anchor chunk before the tile, a multiple of WARPS, then the
    aggregates of the chunks between, in time order), the carry entering
    each warp, the rescan. Edges are identity pairs, as in the kernel."""
    B, S, R = a.shape
    C, W, U, T = rg_ops.CHANNELS, rg_ops.WARPS, plan.steps, plan.T
    Rp, Sp = plan.n_slabs * C, plan.n_chunks * T
    ap = np.ones((B, Sp, Rp), np.float32)
    bp = np.zeros((B, Sp, Rp), np.float32)
    ap[:, :S, :R], bp[:, :S, :R] = a, b
    n_cols = B * plan.n_slabs
    published = {}     # tile -> ("agg", (A, B)) or ("prefix", h)
    h = np.zeros_like(ap)
    for tile in range(plan.n_tiles):
        k, col = divmod(tile, n_cols)
        bi, slab = divmod(col, plan.n_slabs)
        rows = ap[bi, k * T:(k + 1) * T, slab * C:(slab + 1) * C]
        adds = bp[bi, k * T:(k + 1) * T, slab * C:(slab + 1) * C]
        pairs = []
        for w in range(W):
            pa, pb = np.ones(C, np.float32), np.zeros(C, np.float32)
            for u in range(w * U, (w + 1) * U):
                pb = rows[u] * pb + adds[u]
                pa = pa * rows[u]
            pairs.append((pa, pb))
        anchor = k % W == 0
        if not anchor:
            ta, tb = np.ones(C, np.float32), np.zeros(C, np.float32)
            for pa, pb in pairs:
                ta, tb = ta * pa, pa * tb + pb
            published[tile] = ("agg", (ta, tb))
        carry = np.zeros(C, np.float32)
        if k:
            j = (k - 1) // W * W
            assert k - W <= j < k                    # one window of W
            kind, carry = published[j * n_cols + col]
            assert kind == "prefix"
            for kk in range(j + 1, k):
                kind, (xa, xb) = published[kk * n_cols + col]
                assert kind == "agg"
                carry = xa * carry + xb
        c = carry
        for w, (pa, pb) in enumerate(pairs):
            hc = c
            for u in range(w * U, (w + 1) * U):
                hc = rows[u] * hc + adds[u]
                h[bi, k * T + u, slab * C:(slab + 1) * C] = hc
            c = pa * c + pb
        if anchor:
            published[tile] = ("prefix", c)
    return h[:, :S, :R]


# shapes with one chunk, a few, and chains of anchors (S / T past 8 and
# 16 chunks at the shortest tiles), ragged S and R
RG_ALGEBRA_SHAPES = [(1, 100, 200), (2, 33, 31), (3, 70, 64), (1, 300, 40),
                     (1, 1, 5), (2, 64, 32), (1, 520, 33), (4, 17, 3),
                     (1, 129, 64), (2, 200, 70), (1, 8, 1), (3, 150, 10)]


@pytest.mark.parametrize("shape", RG_ALGEBRA_SHAPES, ids=str)
@pytest.mark.parametrize("sms", [1, H100_SMS, 10**6])
def test_k4_lookback_algebra_matches_the_sequential_scan(shape, sms):
    """The anchored look-back's carries give the sequential h (the
    kernel's tolerance: 1e-5 x max(1, max |h|)) on the plans of a card
    with ``sms`` SMs: the longest tiles (1), the H100's, the shortest
    (10**6)."""
    B, S, R = shape
    rng = np.random.default_rng(0)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(
        np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    plan = rg_ops.scan_plan(B, S, R, sms)
    h = _lookback_scan(a, b, plan)
    ref = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.abs(h - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


# K2's forward plan. (Sq, Sk, causal, window): ragged lengths, a suffix
# over a 200-token prefix, Sk - Sq a multiple of the key tile, tiles of 63,
# 65 and 129 rows' edges, bidirectional with a ragged Sk (and with Sk < Sq),
# windows (one wider than the sequence, one without the causal mask, one
# over a suffix), Sq = 1, rows that see no key (Sk < Sq, causal), and
# edges on a tile's first or last key: a window's start (63, 66, 127 keys
# back, with and without the causal mask) and the diagonal (Sk - Sq = 1,
# 62)
FWD_PLAN_CASES = [(100, 100, True, 0), (48, 248, True, 0),
                  (129, 129, True, 0), (63, 191, True, 0),
                  (65, 65, True, 0), (256, 256, True, 0),
                  (70, 137, False, 0), (128, 100, False, 0),
                  (200, 200, True, 48), (37, 300, True, 64),
                  (90, 150, False, 32), (300, 300, True, 2048),
                  (1, 257, True, 0), (1, 300, True, 100), (64, 40, True, 0),
                  (200, 200, True, 63), (200, 200, True, 66),
                  (130, 195, True, 127), (100, 101, True, 0),
                  (200, 200, False, 63), (100, 162, True, 0)]
# the wgmma kernel's blocks: (rows a block, keys a tile) -- at 128 bf16
# columns a row (bf16 d 64 and 128, float32 d 64) 128 rows on 128 keys or
# 64 on 64; at 256 (bf16 d 256, float32 d 128) 128 or 64 rows on 64 keys
FWD_BLOCKS = [(128, 128), (64, 64), (128, 64)]


@functools.lru_cache(maxsize=None)
def _admitted(Sq, Sk, causal, window):
    """The (query row, key) pairs the JAX Pallas kernel admits
    (src/repro/kernels/flash_attention/kernel.py: its liveness and mask),
    read from its interpreted output: q = k = 0 and v the identity, so
    row r of the output is 1/n on each key r sees and 0 elsewhere."""
    q = jnp.zeros((1, 1, Sq, Sk), jnp.float32)
    out = flash_attention_fwd(q, jnp.zeros((1, 1, Sk, Sk), jnp.float32),
                              jnp.eye(Sk, dtype=jnp.float32)[None, None],
                              causal=causal, window=window, block_q=Sq,
                              block_k=Sk, interpret=True)
    return np.asarray(out)[0, 0] > 0


def _visible(Sq, Sk, causal, window):
    """attention.cuh's ``visible`` over every (row, key) pair."""
    r = np.arange(Sq)[:, None]
    c = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= c <= r + Sk - Sq
    if window > 0:
        ok &= c > r + Sk - Sq - window
    return ok


@pytest.mark.parametrize("case", FWD_PLAN_CASES, ids=str)
def test_k2_visible_is_the_jax_kernels_mask(case):
    assert (_visible(*case) == _admitted(*case)).all()


@pytest.mark.parametrize("case", FWD_PLAN_CASES, ids=str)
@pytest.mark.parametrize("rows,keys", [(64, 64), (64, 128), (128, 64),
                                       (128, 128)], ids=str)
def test_k2_fwd_plan_range_is_the_tiles_with_admitted_pairs(case, rows,
                                                            keys):
    """Every admitted (row, key) pair of a query tile falls in its key
    tile range, and every tile in the range holds one."""
    Sq, Sk, causal, window = case
    seen = _admitted(*case)
    plan = fa_ops.fwd_plan(Sq, Sk, causal, window, rows, keys)
    assert len(plan) == -(-Sq // rows)
    for qt, (b, e, edges) in enumerate(plan):
        assert len(edges) == e - b
        tiles = {int(c) // keys for c in np.nonzero(
            seen[qt * rows:(qt + 1) * rows].any(axis=0))[0]}
        assert tiles == set(range(b, e)), (qt, b, e, sorted(tiles))


@pytest.mark.parametrize("case", FWD_PLAN_CASES, ids=str)
@pytest.mark.parametrize("rows,keys", [(64, 64), (64, 128), (128, 64),
                                       (128, 128)], ids=str)
def test_k2_fwd_plan_unflagged_tiles_are_admitted_whole(case, rows, keys):
    """A tile in range that no mask edge crosses is admitted whole by
    every row of the query tile below Sq (the kernel tests none of its
    scores)."""
    Sq, Sk, causal, window = case
    seen = _admitted(*case)
    for qt, (b, e, edges) in enumerate(
            fa_ops.fwd_plan(Sq, Sk, causal, window, rows, keys)):
        for t, edge in zip(range(b, e), edges):
            part = seen[qt * rows:(qt + 1) * rows, t * keys:(t + 1) * keys]
            if not edge:
                assert part.all() and part.shape[1] == keys, (qt, t)


@pytest.mark.parametrize("case", FWD_PLAN_CASES, ids=str)
@pytest.mark.parametrize("block", FWD_BLOCKS, ids=str)
def test_k2_fwd_kernel_emulated_admits_the_jax_kernels_pairs(case, block):
    """The kernel's walk, emulated: each block's key tiles from its rows'
    range, each consumer warpgroup's 64 rows taking a tile whole off an
    edge and ``visible`` on one. What it lets through below Sq is exactly
    the JAX kernel's admitted set."""
    Sq, Sk, causal, window = case
    rows, keys = block
    vis = _visible(*case)
    got = np.zeros((Sq, Sk), bool)
    for qt, (b, e, _) in enumerate(
            fa_ops.fwd_plan(Sq, Sk, causal, window, rows, keys)):
        for wg in range(rows // 64):
            rw = qt * rows + 64 * wg
            for t in range(b, e):
                k_lo = t * keys
                r, c = slice(rw, min(rw + 64, Sq)), slice(k_lo, min(
                    k_lo + keys, Sk))
                if fa_ops._edge_tile(Sq, Sk, causal, window, rw, 64, k_lo,
                                     keys):
                    got[r, c] |= vis[r, c]
                else:
                    got[r, c] = True
    assert (got == _admitted(*case)).all()


# K2's backward on TMA + wgmma: (keys a dK/dV block, rows a query step, rows
# a dQ block, keys a dQ step, the two warpgroups on the same keys or rows)
# of the d-256 kernel (bf16 d 256 and float32 d 128 on 3xBF16: the dK/dV
# warpgroups split dV and dK, the dQ warpgroups alternate key steps) and
# of the 128-key kernels (bf16 d 64 and 128, float32 d 64)
BWD_BLOCKS = [(64, 64, 64, 64, True), (128, 64, 128, 64, False)]


def _bwd_tiles_seen(seen, lo, n, axis, size):
    """The tiles of ``size`` along ``axis`` (0 rows, 1 keys) that hold an
    admitted pair of ``seen`` restricted to [lo, lo + n) on the other."""
    part = seen[:, lo:lo + n] if axis == 0 else seen[lo:lo + n]
    return {int(i) // size for i in np.nonzero(part.any(axis=1 - axis))[0]}


@pytest.mark.parametrize("case", FWD_PLAN_CASES, ids=str)
@pytest.mark.parametrize("block", BWD_BLOCKS, ids=str)
def test_k2_bwd_plan_steps_are_the_tiles_with_admitted_pairs(case, block):
    """Each dK/dV block's query steps are exactly the query tiles whose
    rows see one of its keys, and each dQ block's key steps exactly the
    key tiles its rows see."""
    Sq, Sk, causal, window = case
    kv_keys, q_rows, dq_rows, dq_keys, shared = block
    seen = _admitted(*case)
    dkdv, dq = fa_ops.bwd_plan(Sq, Sk, causal, window, *block)
    assert len(dkdv) == -(-Sk // kv_keys) and len(dq) == -(-Sq // dq_rows)
    for kb, steps in enumerate(dkdv):
        assert {q_lo // q_rows for q_lo, _ in steps} == _bwd_tiles_seen(
            seen, kb * kv_keys, kv_keys, 0, q_rows), kb
    for qt, steps in enumerate(dq):
        assert {k_lo // dq_keys for k_lo, _ in steps} == _bwd_tiles_seen(
            seen, qt * dq_rows, dq_rows, 1, dq_keys), qt


@pytest.mark.parametrize("case", FWD_PLAN_CASES, ids=str)
@pytest.mark.parametrize("block", BWD_BLOCKS, ids=str)
def test_k2_bwd_plan_whole_and_idle_steps(case, block):
    """A warpgroup's step that the kernel takes whole (no score tested) is
    admitted whole, and one it skips as idle holds no admitted pair: the
    dK/dV warpgroups' 64 keys over a query step, the dQ warpgroups' 64
    rows over a key step."""
    Sq, Sk, causal, window = case
    kv_keys, q_rows, dq_rows, dq_keys, shared = block
    seen = _admitted(*case)
    dkdv, dq = fa_ops.bwd_plan(Sq, Sk, causal, window, *block)
    for kb, steps in enumerate(dkdv):
        kws = [kb * kv_keys] * 2 if shared else [kb * kv_keys, kb * kv_keys
                                                 + 64]
        for q_lo, what in steps:
            for kw, w in zip(kws, what):
                part = seen[q_lo:q_lo + q_rows, kw:kw + 64]
                if w == "whole":
                    assert part.shape == (q_rows, 64) and part.all()
                if w == "idle":
                    assert not part.any()
    for qt, steps in enumerate(dq):
        for k_lo, what in steps:
            for i, w in enumerate(what):
                rw = qt * dq_rows + 64 * i
                part = seen[rw:rw + 64, k_lo:k_lo + dq_keys]
                if w == "whole":
                    assert part.shape[1] == dq_keys and part.all()
                if w == "idle":
                    assert not part.any()


@pytest.mark.parametrize("case", FWD_PLAN_CASES, ids=str)
@pytest.mark.parametrize("block", BWD_BLOCKS, ids=str)
def test_k2_bwd_kernels_emulated_admit_the_jax_kernels_pairs(case, block):
    """The two kernels' walks, emulated: each warpgroup's steps, a whole
    step taken whole and an edge step through ``visible``. The pairs that
    reach dV, dK (each warpgroup of a shared block apart) and dQ are
    exactly the JAX kernel's admitted set, each once."""
    Sq, Sk, causal, window = case
    kv_keys, q_rows, dq_rows, dq_keys, shared = block
    vis = _visible(*case)
    dkdv, dq = fa_ops.bwd_plan(Sq, Sk, causal, window, *block)
    got = [np.zeros((Sq, Sk), int) for _ in range(3)]
    for kb, steps in enumerate(dkdv):
        kws = [kb * kv_keys] * 2 if shared else [kb * kv_keys, kb * kv_keys
                                                 + 64]
        for q_lo, what in steps:
            for i, (kw, w) in enumerate(zip(kws, what)):
                r = slice(q_lo, min(q_lo + q_rows, Sq))
                c = slice(kw, min(kw + 64, Sk))
                hit = (vis[r, c] if w == "edge" else
                       np.full(vis[r, c].shape, w == "whole"))
                # shared: warpgroup 0 takes dV, 1 dK; else each both
                for out in ((got[i],) if shared else got[:2]):
                    out[r, c] += hit
    for qt, steps in enumerate(dq):
        for k_lo, what in steps:
            for i, w in enumerate(what):
                r = slice(qt * dq_rows + 64 * i, min(qt * dq_rows + 64 * i
                                                     + 64, Sq))
                c = slice(k_lo, min(k_lo + dq_keys, Sk))
                got[2][r, c] += (vis[r, c] if w == "edge" else
                                 np.full(vis[r, c].shape, w == "whole"))
    want = _admitted(*case).astype(int)
    assert all((g == want).all() for g in got)


@pytest.mark.parametrize("B,Hkv,g,splits", [(1, 1, 10, 5), (2, 1, 5, 5),
                                            (2, 4, 3, 1), (2, 8, 3, 1),
                                            (1, 1, 4, 4), (1, 2, 6, 3)],
                         ids=str)
def test_k2_bwd_group_splits_at_the_d256_key_block(B, Hkv, g, splits):
    """recurrentgemma-2b's one kv head leaves 32 key blocks of 64 a row:
    its group of 10 (5 a rank on the model axis) is split in 5 so the
    dK/dV blocks fill 132 SMs; llama's 24/8 and 12/4 are not. The parts
    take the group's heads in order, each at least one."""
    kb = fa_ops.PART_KEY_BLOCK
    assert fa_ops.group_splits(B, Hkv, 2048, g, kb, H100_SMS) == splits
    heads = fa_ops.split_heads(g, splits)
    assert [h for part in heads for h in part] == list(range(g))
    assert all(len(part) >= 1 for part in heads)
    assert B * Hkv * -(-2048 // kb) * splits >= H100_SMS or splits == g


def _bf16(x):
    """float32 rounded to the nearest bfloat16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _product(a, b, parts):
    """a @ b as the 3xBF16 route computes it (parts 2): each float32
    operand split into hi = bf16(x) and lo = bf16(x - hi), then lo hi + hi
    lo + hi hi summed in float32 (products of two bf16 are exact in
    float32); with parts 1 a single bf16 product."""
    def split(x):
        hi = _bf16(x)
        return hi, _bf16(x - hi)
    (ah, al), (bh, bl) = split(a), split(b)
    if parts == 1:
        return ah @ bh
    return ((al @ bh).astype(np.float32) + (ah @ bl).astype(np.float32)
            + (ah @ bh).astype(np.float32)).astype(np.float32)


def _bwd_route_emulated(q, k, v, do, causal, window, parts):
    """(dq, dk, dv) of one head as the float32 route computes them: the
    forward's out and L in float32, D = rowsum(dO O) in float32, every
    product through ``_product``, P and dS in float32 between them; and
    the same backward dense in float64."""
    Sq, Sk, d = q.shape[0], k.shape[0], q.shape[1]
    scale = d ** -0.5
    vis = _visible(Sq, Sk, causal, window)
    s64 = np.where(vis, (q.astype(np.float64) @ k.T) * scale, -np.inf)
    m = s64.max(1, keepdims=True)
    L64 = np.log(np.exp(s64 - m).sum(1, keepdims=True)) + m
    p64 = np.exp(s64 - L64)
    D64 = (do * (p64 @ v)).sum(1, keepdims=True)
    ds64 = p64 * (do.astype(np.float64) @ v.T - D64)
    want = (ds64 @ k * scale, ds64.T @ q * scale, p64.T @ do)
    L, D = L64.astype(np.float32), D64.astype(np.float32)
    sc = np.float32(scale)
    p = np.where(vis, np.exp(_product(q, k.T, parts) * sc - L), 0)
    p = p.astype(np.float32)
    ds = (p * (_product(do, v.T, parts) - D)).astype(np.float32)
    got = (_product(ds, k, parts) * sc, _product(ds.T, q, parts) * sc,
           _product(p.T, do, parts))
    return got, want


# one head: a small ragged case with a window, and 256 rows over 2048 keys
# (the sums over 2048 keys of the training shapes) at d 128
BWD_EMU_CASES = [(40, 72, 64, True, 24), (256, 2048, 128, True, 0)]


@pytest.mark.parametrize("case", BWD_EMU_CASES, ids=str)
def test_k2_bwd_3xbf16_route_within_the_float32_tolerance(case):
    """The float32 route's arithmetic (two bf16 parts, three products)
    keeps dq, dk and dv within 1e-4 x max of the float64 backward, the
    tolerance the card holds float32 to; one bf16 product misses it."""
    Sq, Sk, d, causal, window = case
    rng = np.random.default_rng(12)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((Sq, d), (Sk, d), (Sk, d), (Sq, d)))
    for parts, within in ((2, True), (1, False)):
        got, want = _bwd_route_emulated(q, k, v, do, causal, window, parts)
        rel = [np.abs(a - b).max() / np.abs(b).max()
               for a, b in zip(got, want)]
        assert all(r <= 1e-4 for r in rel) == within, (parts, rel)
        if within:
            assert max(rel) <= 5e-5, rel      # a margin of 2x at least
        else:
            assert min(rel) > 1e-3, rel


def _fwd_route_emulated(q, k, v, causal, window, parts):
    """out and L of one head as the float32 forward route computes them:
    S = Q K^T through ``_product``, the softmax in float32, P kept in
    float32 and split into its two parts for P V (``_product``; with parts
    1 rounded to bf16, as the bf16 route rounds it); and the same forward
    dense in float64."""
    d = q.shape[1]
    scale = d ** -0.5
    vis = _visible(q.shape[0], k.shape[0], causal, window)
    s64 = np.where(vis, (q.astype(np.float64) @ k.T) * scale, -np.inf)
    m64 = s64.max(1, keepdims=True)
    e64 = np.exp(s64 - m64)
    l64 = e64.sum(1, keepdims=True)
    want = (e64 @ v / l64, (np.log(l64) + m64)[:, 0])
    sc = np.float32(scale)
    s = _product(q, k.T, parts)            # raw scores, float32
    m = np.where(vis, s, -np.inf).max(1, keepdims=True)
    p = np.where(vis, np.exp((s - m) * sc), 0).astype(np.float32)
    lsum = p.sum(1, keepdims=True, dtype=np.float32)
    got = (_product(p, v, parts) / lsum, (m * sc + np.log(lsum))[:, 0])
    return got, want


@pytest.mark.parametrize("case", BWD_EMU_CASES, ids=str)
def test_k2_fwd_3xbf16_route_within_the_float32_tolerance(case):
    """The float32 forward route's arithmetic (two bf16 parts, three
    products a product, P's two parts) keeps out within 1e-4 and L within
    1e-4 x max(1, max |L|) of the float64 forward, the tolerances the
    card holds float32 to, with a margin of 2x; one bf16 pass misses."""
    Sq, Sk, d, causal, window = case
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Sq, d), (Sk, d), (Sk, d)))
    for parts, within in ((2, True), (1, False)):
        (out, L), (want_out, want_L) = _fwd_route_emulated(
            q, k, v, causal, window, parts)
        err = (float(np.abs(out - want_out).max()),
               float(np.abs(L - want_L).max())
               / max(1.0, float(np.abs(want_L).max())))
        if within:
            assert max(err) <= 5e-5, (parts, err)     # 1e-4 with 2x margin
        else:
            assert err[0] > 1e-4, (parts, err)
