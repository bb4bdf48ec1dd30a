"""Gradients of the port's kernel wrappers (``torch.autograd.Function``s)
against ``jax.grad`` of the JAX package's ``custom_vjp`` wrappers, on the
CPU, run as tests/test_kernels.py runs them (the Pallas forward in
interpret mode, the backward through the oracles).

Inputs are drawn once with numpy and handed to both packages. Tolerances,
relative to the largest reference gradient of each input: 1e-5 for K2 and
K4 (the same arithmetic in float32, summed in other orders), 1e-4 for K5
(its backward runs the chunked algorithm at the JAX wrapper's chunk, the
port's at the forward's chunk: the same function, summed differently).
The port's backward recomputes its plain version, so its grads on the CPU
equal autograd through that version; the Functions' forward launch
counters stay at zero on the CPU. Also: remat ``full`` and ``dots`` give
the same loss and grads as no remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.rglru_scan.ops import rglru_scan as j_rglru
from repro.kernels.ssd.ops import ssd as j_ssd
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import _ssd_chunked
from repro_torch.models.params import materialize, tree_leaves
from repro_torch.models.transformer import Model

pytestmark = pytest.mark.kernels


def _grads_close(jgrads, tgrads, tol):
    for j, t in zip(jgrads, tgrads):
        j = np.asarray(j)
        err = np.abs(j - t.numpy()).max()
        assert err <= tol * np.abs(j).max(), (err, np.abs(j).max())


def _torch_vjp(fn, inputs, cotangent):
    xs = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*xs)
    out = out[0] if isinstance(out, tuple) else out
    out.backward(torch.from_numpy(cotangent))
    return [x.grad for x in xs]


FA_CASES = [  # B, Hq, Hkv, S, d, window
    (1, 4, 2, 64, 32, 0),
    (2, 2, 1, 64, 16, 24),
]


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_attention_grads_match_jax(case):
    B, Hq, Hkv, S, d, window = case
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, S, d), (B, Hkv, S, d), (B, Hkv, S, d)))
    g = rng.standard_normal((B, Hq, S, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda *x: j_flash(*x, True, window), q, k, v)
    before = fa_ops.launches
    tgrads = _torch_vjp(lambda *x: fa_ops.flash_attention(
        *x, causal=True, window=window), (q, k, v), g)
    _grads_close(vjp(jnp.asarray(g)), tgrads, 1e-5)
    # the backward is autograd through the plain version, exactly
    ref = _torch_vjp(lambda *x: flash_attention_ref(
        *x, causal=True, window=window), (q, k, v), g)
    for a, b in zip(tgrads, ref):
        assert torch.equal(a, b)
    assert fa_ops.launches == before


def test_rglru_scan_grads_match_jax():
    rng = np.random.default_rng(1)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, 48, 32))))).astype(
        np.float32)
    b = rng.standard_normal((2, 48, 32)).astype(np.float32)
    g = rng.standard_normal((2, 48, 32)).astype(np.float32)
    _, vjp = jax.vjp(j_rglru, a, b)
    before = rg_ops.launches
    tgrads = _torch_vjp(rg_ops.rglru_scan, (a, b), g)
    _grads_close(vjp(jnp.asarray(g)), tgrads, 1e-5)
    # the reverse recurrence equals autograd through the sequential scan
    _grads_close(_torch_vjp(rglru_scan_ref, (a, b), g), tgrads, 1e-5)
    assert rg_ops.launches == before


def _ssd_inputs(b, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(
        np.float32) * 0.5
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32)
    C = rng.standard_normal((b, S, N)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_grads_match_jax(chunk):
    inputs = _ssd_inputs(1, 64, 2, 16, 8, seed=2)
    g = np.random.default_rng(3).standard_normal((1, 64, 2, 16)).astype(
        np.float32)
    _, vjp = jax.vjp(j_ssd, *inputs)
    before = ssd_ops.launches
    tgrads = _torch_vjp(lambda *x: ssd_ops.ssd(*x, chunk), inputs, g)
    _grads_close(vjp(jnp.asarray(g)), tgrads, 1e-4)
    assert ssd_ops.launches == before


def test_ssd_final_state_gradient():
    """The port's ssd also returns the final state (JAX's returns y only):
    its gradient is autograd through the plain chunked version, and a
    state that nothing uses contributes zero."""
    inputs = _ssd_inputs(2, 32, 2, 16, 8, seed=4)
    rng = np.random.default_rng(5)
    gy = torch.from_numpy(rng.standard_normal((2, 32, 2, 16)).astype(
        np.float32))
    gs = torch.from_numpy(rng.standard_normal((2, 2, 8, 16)).astype(
        np.float32))

    def grads(fn, with_state):
        xs = [torch.from_numpy(a).requires_grad_() for a in inputs]
        y, state = fn(*xs, 8)
        loss = (y * gy).sum() + ((state * gs).sum() if with_state else 0)
        loss.backward()
        return [x.grad for x in xs]

    for with_state in (True, False):
        for a, b in zip(grads(ssd_ops.ssd, with_state),
                        grads(_ssd_chunked, with_state)):
            assert torch.allclose(a, b, rtol=0, atol=1e-5 * float(
                b.abs().max()))


@pytest.mark.parametrize("arch", ["llama3.2-3b-smoke", "mamba2-2.7b-smoke",
                                  "recurrentgemma-2b-smoke"])
def test_remat_keeps_loss_and_grads(arch):
    cfg = get_config(arch)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 16)))
    out = {}
    for remat in ("none", "full", "dots"):
        m = Model(cfg, act_dtype=torch.float32, remat=remat)
        params = materialize(m.param_defs(), 0)
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        logits, aux = m.forward(params, toks)
        loss = logits.float().square().mean() + aux
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(
                b.abs().max()) + 1e-30), remat


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError, match="remat"):
        Model(get_config("llama3.2-3b-smoke"), remat="everything")


def test_dots_policy_saves_products_without_batch_dims():
    """``remat="dots"`` keeps what ``dots_with_no_batch_dims_saveable``
    keeps: plain matrix products (``mm``, ``addmm``, and the batch-of-one
    ``bmm`` that ``einsum`` runs for a projection), not the attention's
    batched products or elementwise ops."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models.transformer import _save_dots
    aten = torch.ops.aten
    x, w = torch.zeros(1, 10, 8), torch.zeros(1, 8, 12)
    assert _save_dots(None, aten.mm.default, x[0], w[0]) == \
        CheckpointPolicy.MUST_SAVE
    assert _save_dots(None, aten.bmm.default, x, w) == \
        CheckpointPolicy.MUST_SAVE
    assert _save_dots(None, aten.bmm.default, x.expand(4, 10, 8),
                      w.expand(4, 8, 12)) == CheckpointPolicy.PREFER_RECOMPUTE
    assert _save_dots(None, aten.mul.Tensor, x, x) == \
        CheckpointPolicy.PREFER_RECOMPUTE
