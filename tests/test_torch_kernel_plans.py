"""The pure functions that plan the port's CUDA launches, held without a
card: K1's span plan (which block covers which positions) and its kernel
choice, and K5's P slice and scratch shapes. They decide before a launch,
from shapes alone, what the kernels in ``repro_torch/csrc`` then do, so a
wrong plan shows here on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops as pa_ops
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
