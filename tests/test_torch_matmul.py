"""K3, the blocked matmul: the port's wrapper on CPU tensors against the
JAX package's Pallas kernel in interpret mode (as tests/test_kernels.py
runs it), on the same numpy inputs.

Tolerances are the JAX suite's: max-abs 1e-3 in float32; in bfloat16 the
outputs are compared after a cast to float32 within 2.0 (one bf16 rounding
of values up to ~30, and the Pallas kernel rounds per K block sum where the
port rounds once). The block table is resolved from the tensor's device
and shrinks to divide the shape exactly as the JAX wrapper's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.matmul.ops as jops
from repro.kernels.matmul.ref import matmul_ref as jmatmul_ref
from repro_torch.kernels.matmul import ops
from repro_torch.kernels.matmul.ref import matmul_ref

pytestmark = pytest.mark.kernels

# tests/test_kernels.py:159 (M, K, N, dtype), plus a ragged case the
# port's kernel masks (the JAX wrapper asserts the blocks divide)
MM_CASES = [(256, 256, 256, "float32"), (128, 384, 256, "bfloat16"),
            (64, 64, 64, "float32"), (512, 128, 256, "bfloat16")]


def _inputs(M, K, N, dt, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dt)), jnp.asarray(b, getattr(jnp, dt)),
            torch.from_numpy(a).to(getattr(torch, dt)),
            torch.from_numpy(b).to(getattr(torch, dt)))


@pytest.mark.parametrize("case", MM_CASES, ids=str)
def test_matmul_matches_jax_kernel(case):
    M, K, N, dt = case
    ja, jb, ta, tb = _inputs(M, K, N, dt)
    jout = np.asarray(jops.matmul(ja, jb).astype(jnp.float32))
    before = ops.launches
    out = ops.matmul(ta, tb)
    assert ops.launches == before          # CPU tensors run the plain version
    assert out.dtype == ta.dtype and tuple(out.shape) == (M, N)
    err = float(np.abs(out.float().numpy() - jout).max())
    assert err < (2.0 if dt == "bfloat16" else 1e-3), err
    # the plain version mirrors the JAX oracle
    jref = np.asarray(jmatmul_ref(ja, jb).astype(jnp.float32))
    ref_err = float(np.abs(matmul_ref(ta, tb).float().numpy() - jref).max())
    assert ref_err < (2.0 if dt == "bfloat16" else 1e-3), ref_err


@pytest.mark.parametrize("case", MM_CASES + [(100, 200, 300, "float32"),
                                             (8, 24, 40, "bfloat16")],
                         ids=str)
def test_blocks_shrink_as_the_jax_wrapper(case, monkeypatch):
    """The cpu entry's blocks equal the blocks the JAX wrapper hands its
    kernel (``cpu-interpret`` entry, ops.py:23-33) for the same shape."""
    M, K, N, dt = case
    seen = {}

    def capture(a, b, *, block_m, block_n, block_k, interpret):
        seen["blocks"] = (block_m, block_n, block_k)
        return jnp.zeros((a.shape[0], b.shape[1]), a.dtype)
    monkeypatch.setattr(jops, "matmul_pallas", capture)
    ja, jb, _, _ = _inputs(M, K, N, dt)
    jops.matmul(ja, jb)
    assert ops.BLOCK_TABLE["cpu"] == jops.BLOCK_TABLE["cpu-interpret"]
    assert ops.blocks(M, N, K, "cpu") == seen["blocks"]


def test_block_table_and_platform_resolution():
    assert set(ops.BLOCK_TABLE) == {"h100", "cpu"}
    # reported as the fig5 analog's binding: the largest tensor-core tile,
    # 128 x 256 outputs, 64 deep
    assert ops.BLOCK_TABLE["h100"] == (128, 256, 64)
    assert ops.BLOCK_TABLE["h100"][:2] == ops.TILES["wgmma"][0]
    assert ops._platform(torch.device("cpu")) == "cpu"
    with pytest.raises(ValueError, match="no kernel for device"):
        ops._platform(torch.device("meta"))
    # llama3.2-3b's prefill MLP products keep the full h100 tile
    assert ops.blocks(512, 8192, 3072, "h100") == (128, 256, 64)
    assert ops.blocks(512, 3072, 8192, "h100") == (128, 256, 64)
    # a ragged shape shrinks the JAX wrapper's blocks to the floor of 8
    assert ops.blocks(100, 300, 200, "h100") == (8, 8, 8)
    a = torch.ones(4, 8)
    with pytest.raises(ValueError, match="are for cuda tensors"):
        ops.matmul(a, a.T, platform="h100")
    with pytest.raises(ValueError, match="unknown platform"):
        ops.matmul(a, a.T, platform="tpu-v5e")


def test_ragged_and_empty_shapes_on_cpu():
    """Shapes the JAX wrapper's blocks do not divide still compute on the
    port (the kernel masks them; the CPU runs the plain version)."""
    _, _, ta, tb = _inputs(100, 200, 300, "float32")
    out = ops.matmul(ta, tb)
    np.testing.assert_allclose(out.numpy(), ta.numpy() @ tb.numpy(),
                               rtol=1e-5, atol=1e-4)
    z = ops.matmul(torch.zeros(3, 0), torch.zeros(0, 5))
    assert tuple(z.shape) == (3, 5) and not z.any()


# llama3.2-3b's prefill MLP products for a 512-token prompt: gate/up
# (N 8192), down (K 8192, N 3072)
LLAMA_MLP = [(512, 3072, 8192), (512, 8192, 3072)]


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("mkn", LLAMA_MLP, ids=str)
def test_kernel_choice_fills_the_card_at_llama_mlp(mkn, dt):
    """gate/up and down get a tile whose grid has at least 96 blocks for the
    132 SMs (128 x 128 tiles at the down product give exactly 96)."""
    M, K, N = mkn
    kernel, bm, bn = ops.kernel_choice(M, N, K, getattr(torch, dt))
    assert kernel == ("wgmma" if dt == "bfloat16" else "fma")
    assert (bm, bn) in ops.TILES[kernel]
    assert -(-M // bm) * -(-N // bn) >= 96


def test_kernel_choice_gate_up_runs_the_block_table_tile():
    assert ops.kernel_choice(512, 8192, 3072, torch.bfloat16) == \
        ("wgmma", *ops.BLOCK_TABLE["h100"][:2])


@pytest.mark.parametrize("case", [
    (512, 3072, 8192, torch.float32),      # float32: FMA whatever the shape
    (64, 64, 64, torch.float32),
    (100, 200, 300, torch.bfloat16),       # N % 8 != 0: no TMA row stride
    (96, 100, 136, torch.bfloat16),        # K % 8 != 0
    (3, 0, 5, torch.bfloat16),             # K = 0: nothing for TMA to load
], ids=str)
def test_kernel_choice_takes_fma_where_tma_cannot(case):
    M, K, N, dt = case
    assert ops.kernel_choice(M, N, K, dt)[0] == "fma"


@pytest.mark.parametrize("case", [(100, 200, 304), (128, 384, 256),
                                  (1280, 256, 1280), (1, 8, 8)], ids=str)
def test_kernel_choice_takes_tensor_cores_where_tma_can(case):
    """bfloat16 with K and N multiples of 8, ragged M included."""
    M, K, N = case
    kernel, bm, bn = ops.kernel_choice(M, N, K, torch.bfloat16)
    assert kernel == "wgmma" and (bm, bn) in ops.TILES["wgmma"]


def test_kernel_choice_is_a_function_of_the_shape():
    """Deterministic, and the largest tile that still fills its kernel's
    MIN_BLOCKS:
    the same shape always runs the same code (the fig5 bitwise check)."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        M, N, K = (int(x) for x in rng.integers(1, 9000, 3))
        dt = (torch.bfloat16, torch.float32)[int(rng.integers(2))]
        kernel, bm, bn = ops.kernel_choice(M, N, K, dt)
        assert ops.kernel_choice(M, N, K, dt) == (kernel, bm, bn)
        tiles = ops.TILES[kernel]
        grid = -(-M // bm) * -(-N // bn)
        i = tiles.index((bm, bn))
        # every larger tile falls short; this one fills, unless it is last
        assert all(-(-M // tm) * -(-N // tn) < ops.MIN_BLOCKS[kernel]
                   for tm, tn in tiles[:i])
        assert grid >= ops.MIN_BLOCKS[kernel] or i == len(tiles) - 1
