"""K2's backward routes, on the CPU.

* the dense plain backward from L (``flash_attention_bwd_ref``, the
  equations of the backward kernels) against autograd through the plain
  forward and against ``jax.vjp`` of the JAX package's
  ``flash_attention`` (the Pallas forward in interpret mode, the backward
  the vjp of its oracle), within 1e-5 of each input's largest gradient:
  GQA groups 1, 2 and 3, windows 0 and 24, suffixes with Sq < Sk, head
  dims 16 and 80;
* the forward's L (``flash_attention_lse_ref``) against a numpy
  log-sum-exp in float64, +inf on a row that sees no key;
* a traced smoke training step on ``meta`` counts each attention layer's
  backward as one ``flash_attention_bwd`` call at ``cost_bwd()``;
* with tensors that claim a card, the backward builds its kernel or
  raises and never reaches a plain version;
* the GQA group splits of the dK/dV grid at the shapes training gives it,
  at the key blocks of 64 (``mma.sync``) and of 128 (``wgmma``).

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.core.container import Container
from repro_torch.core.image import ImageBuilder
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref,
                                                     flash_attention_ref)

pytestmark = pytest.mark.kernels

CASES = [  # B, Hq, Hkv, Sq, Sk, d, window
    (1, 2, 2, 48, 48, 16, 0),
    (2, 4, 2, 40, 40, 16, 24),
    (1, 6, 2, 16, 48, 80, 0),
    (1, 3, 1, 32, 64, 80, 24),
]


def _inputs(B, Hq, Hkv, Sq, Sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d),
                      (B, Hq, Sq, d))]


def _close(got, want, tol=1e-5):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(g, np.float64) - w).max()
        assert err <= tol * np.abs(w).max(), (err, np.abs(w).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_autograd_and_jax(case):
    B, Hq, Hkv, Sq, Sk, d, window = case
    q, k, v, g = _inputs(B, Hq, Hkv, Sq, Sk, d)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    lse = flash_attention_lse_ref(tq, tk, causal=True, window=window)
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, causal=True,
                                  window=window)
    assert [t.dtype for t in got] == [torch.float32] * 3
    assert [t.shape for t in got] == [tq.shape, tk.shape, tv.shape]
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(
        flash_attention_ref(*xs, causal=True, window=window), xs, tg)
    _close([t.numpy() for t in got], [t.numpy() for t in auto])
    # jitted: the same vjp, compiled once instead of dispatched op by op
    jvjp = jax.jit(lambda *x: jax.vjp(
        lambda *y: j_flash(*y, True, window), *x[:3])[1](x[3]))
    _close([t.numpy() for t in got], jvjp(q, k, v, g))


@pytest.mark.parametrize("Sq,Sk,window", [(24, 24, 0), (24, 40, 7),
                                          (12, 8, 0)], ids=str)
def test_lse_matches_numpy(Sq, Sk, window):
    """Sq > Sk leaves the first rows with no key: their L is +inf."""
    q, k, _, _ = _inputs(1, 4, 2, Sq, Sk, 16, seed=1)
    got = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  causal=True, window=window).numpy()
    s = np.einsum("bhgqd,bhkd->bhgqk", q.reshape(1, 2, 2, Sq, 16)
                  .astype(np.float64), k.astype(np.float64)) * 16 ** -0.5
    qi, ki = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    seen = ki <= qi + Sk - Sq
    if window:
        seen &= ki > qi + Sk - Sq - window
    s = np.where(seen, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    want = np.where(seen.any(-1), want, np.inf).reshape(1, 4, Sq)
    assert got.dtype == np.float32
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * np.abs(want).max()
    assert (Sq > Sk) == bool(np.isinf(got).any())


def test_meta_step_counts_the_backward():
    """llama3.2-3b-smoke traced on ``meta`` under remat=full: each
    attention layer's forward twice (the recompute) and its backward as
    one ``flash_attention_bwd`` call at ``cost_bwd()`` of its shape (one
    backward launch on a card)."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-3b-smoke")
    S, B = 16, 2
    img = (ImageBuilder.from_scratch().arch("llama3.2-3b-smoke")
           .shape("train_4k", seq_len=S, global_batch=B).mesh("local")
           .precision(params="float32", compute="float32")
           .collectives("generic").set(remat="full").build())
    counter = Container(img, platform="local",
                        device="meta").lower_step("train").counter
    L = cfg.n_layers
    assert counter.kernel_calls == {"flash_attention_fwd": 2 * L,
                                    "flash_attention_bwd": L}
    flops, nbytes = fa_ops.cost_bwd(B, cfg.n_heads, cfg.n_kv_heads, S, S,
                                    cfg.head_dim, 4)
    assert counter.by_op["kernel:flash_attention_bwd"] == [L * flops,
                                                           L * nbytes, L]
    # five products a seen (q, k) pair against the forward's two
    f_flops, _ = fa_ops.cost(B, cfg.n_heads, cfg.n_kv_heads, S, S,
                             cfg.head_dim, 4)
    assert flops == 2.5 * f_flops


def test_card_backward_builds_its_kernel_or_raises(monkeypatch):
    """Handed tensors on a card, the backward reaches the build of its
    kernels (which raises here) and neither plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs instead")
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = []
    for name in ("flash_attention_bwd_ref", "flash_attention_ref",
                 "_out_lse_ref"):
        monkeypatch.setattr(fa_ops, name, lambda *a, **kw: calls.append(1))

    def no_library(name):
        raise RuntimeError(f"cannot build {name}: no nvcc")
    monkeypatch.setattr(_build, "load", no_library)
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty((1, 4, 32, 16), device="cuda")
        kv = torch.empty((1, 2, 32, 16), device="cuda")
        lse = torch.empty((1, 4, 32), device="cuda")
    before = fa_ops.bwd_launches
    with pytest.raises(RuntimeError, match="cannot build flash_attention_bwd"):
        fa_ops._backward(q, kv, kv, q, lse, q, True, 0, None)
    assert not calls and fa_ops.bwd_launches == before


@pytest.mark.parametrize("shape,want", [
    ((2, 8, 2048, 3, 64), 1),      # llama3.2-3b training, one process
    ((2, 4, 2048, 3, 64), 1),      # its rank of a (1, 2) mesh
    ((1, 1, 2048, 10, 64), 5),     # recurrentgemma-2b: 32 key blocks
    ((2, 1, 2048, 5, 64), 5),      # its rank of a (1, 2) mesh
    ((1, 16, 2048, 1, 64), 1),     # moonshot: no group to split
    ((1, 1, 64, 3, 32), 3),        # a short sequence: the whole group
    # bf16 at d 64 and 128: the wgmma kernels' 128-key blocks
    ((2, 8, 2048, 3, 128), 1),     # llama3.2-3b training: 256 blocks
    ((2, 4, 2048, 3, 128), 3),     # its (1, 2) rank: 128 blocks, short
    ((2, 16, 2048, 1, 128), 1),    # moonshot
], ids=str)
def test_group_splits(shape, want):
    assert fa_ops.group_splits(*shape, sms=132) == want
