"""K5's backward routes, on the CPU.

* the plain backward ``ssd_bwd_ref`` (the vjp of ``_ssd_chunked`` in the
  phases the CUDA backward runs) against autograd through
  ``_ssd_chunked``, within 1e-5 of each input's largest gradient, and,
  where no gradient reaches the final state, against ``jax.vjp`` of the
  JAX package's ``ssd`` (the Pallas forward in interpret mode, the
  backward the vjp of its chunked XLA path at chunk min(256, S)) within
  1e-4, as tests/test_torch_grad.py holds the Function. The cases: one
  chunk and several, b = 2, a decay that drives exponents past the clip
  at -60, and the zero tail ``ssm_forward`` pads a sequence with. The
  plain backward runs in float32 and is held to autograd in float64:
  at the clipped decay float32 autograd's own dA is more than 1e-5 of its
  largest value away from the float64 one (a sum over positions whose
  terms cancel), so the float64 gradient is the one that tells the
  algorithm's error from the reference's rounding;
* the Function's CPU backward is that plain backward, bit for bit, and
  launches nothing;
* a traced smoke training step on ``meta`` counts each ``ssm`` layer's
  backward as one ``ssd_bwd`` call at ``cost_bwd()``;
* with tensors that claim a card, the backward builds its kernel or
  raises and never reaches a plain version;
* the backward's head groups cover every head.

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as j_ssd
from repro_torch.configs import get_config
from repro_torch.core.container import Container
from repro_torch.core.image import ImageBuilder
from repro_torch.kernels import _build, bwd_launch_counts
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import _ssd_chunked, ssd_bwd_ref

pytestmark = pytest.mark.kernels

CASES = {  # (b, S, H, P, N, chunk), how the inputs are drawn
    "chunks": ((1, 64, 2, 16, 8, 16), {}),
    "one chunk": ((1, 64, 2, 16, 8, 64), {}),
    "b2": ((2, 64, 3, 16, 8, 16), {}),
    "clipped": ((2, 64, 2, 16, 8, 32), {"A": -8.0}),
    "zero tail": ((1, 64, 2, 16, 8, 16), {"tail": 10}),
}


def _inputs(case, with_state, A=None, tail=0, seed=0):
    """x, dt, A, B, C, gy and gstate (zero or drawn) as numpy float32;
    ``A`` fixes every head's decay; ``tail`` zeroes the last positions'
    x, dt, B, C and gy, as ssm_forward pads a sequence to a chunk
    multiple and slices the padded outputs off."""
    b, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H))))
    A = (-np.exp(0.5 * rng.standard_normal(H)) if A is None
         else np.full(H, A))
    B = rng.standard_normal((b, S, N))
    C = rng.standard_normal((b, S, N))
    gy = rng.standard_normal((b, S, H, P))
    gstate = (rng.standard_normal((b, H, N, P)) if with_state
              else np.zeros((b, H, N, P)))
    for a in (x, dt, B, C, gy):
        a[:, S - tail:] = 0
    return [np.asarray(a, np.float32) for a in (x, dt, A, B, C, gy, gstate)]


def _close(got, want, tol):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (err, np.abs(w).max())


def _autograd(arrays, chunk, dtype):
    *ins, gy, gstate = (torch.from_numpy(a).to(dtype) for a in arrays)
    xs = [t.requires_grad_() for t in ins]
    y, state = _ssd_chunked(*xs, chunk)
    return torch.autograd.grad(((y * gy).sum() + (state * gstate).sum()),
                               xs)


@pytest.mark.parametrize("with_state", [False, True], ids=["gstate0", "gstate"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_autograd(name, with_state):
    case, kw = CASES[name]
    arrays = _inputs(case, with_state, **kw)
    chunk = case[-1]
    if name == "clipped":
        # the decay really reaches the clip inside a chunk
        cum = np.cumsum((arrays[1] * arrays[2]).reshape(
            case[0], -1, chunk, case[2]), axis=2)
        assert (cum[:, :, -1] - cum[:, :, 0]).min() < -60
    *ins, gy, gstate = (torch.from_numpy(a) for a in arrays)
    got = ssd_bwd_ref(*ins, chunk, gy, gstate if with_state else None)
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, _autograd(arrays, chunk, torch.float64), 1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax(name):
    case, kw = CASES[name]
    arrays = _inputs(case, False, **kw)
    *ins, gy, _ = arrays
    _, vjp = jax.vjp(j_ssd, *ins)
    want = vjp(jnp.asarray(gy))
    got = ssd_bwd_ref(*(torch.from_numpy(a) for a in ins), case[-1],
                      torch.from_numpy(gy))
    _close(got, want, 1e-4)


def test_function_backward_is_the_plain_backward():
    """ssd's CPU backward, for y and the final state (or y alone), equals
    ssd_bwd_ref bit for bit and moves no counter."""
    case, _ = CASES["chunks"]
    arrays = _inputs(case, True)
    *ins, gy, gstate = (torch.from_numpy(a) for a in arrays)
    before = ssd_ops.launches, bwd_launch_counts()
    for state in (gstate, None):
        xs = [t.clone().requires_grad_() for t in ins]
        y, fin = ssd_ops.ssd(*xs, case[-1])
        outs, cots = ((y, fin), (gy, state)) if state is not None \
            else ((y,), (gy,))
        got = torch.autograd.grad(outs, xs, cots)
        want = ssd_bwd_ref(*ins, case[-1], gy, state)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (ssd_ops.launches, bwd_launch_counts()) == before


def test_meta_step_counts_the_backward():
    """mamba2-2.7b-smoke traced on ``meta`` under remat=full: each ssm
    layer's forward twice and its backward once, one ``ssd_bwd`` call at
    ``cost_bwd()`` of its shape."""
    cfg = get_config("mamba2-2.7b-smoke")
    S, B = 16, 2
    img = (ImageBuilder.from_scratch().arch("mamba2-2.7b-smoke")
           .shape("train_4k", seq_len=S, global_batch=B).mesh("local")
           .precision(params="float32", compute="float32")
           .collectives("generic").set(remat="full").build())
    counter = Container(img, platform="local",
                        device="meta").lower_step("train").counter
    n = cfg.layer_types().count("ssm")
    assert n > 0
    assert counter.kernel_calls == {"ssd": 2 * n, "ssd_bwd": n}
    chunk = min(cfg.ssm_chunk, S)
    flops, nbytes = ssd_ops.cost_bwd(B, S, cfg.ssm_heads, cfg.ssm_headdim,
                                     cfg.ssm_state, chunk)
    assert counter.by_op["kernel:ssd_bwd"] == [n * flops, n * nbytes, n]


def test_card_backward_builds_its_kernel_or_raises(monkeypatch):
    """Handed tensors on a card, the backward reaches the build of its
    kernel (which raises here) and not a plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs instead")
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = []
    for name in ("ssd_bwd_ref", "_ssd_chunked"):
        monkeypatch.setattr(ssd_ops, name, lambda *a, **kw: calls.append(1))

    def no_library(name):
        raise RuntimeError(f"cannot build {name}: no nvcc")
    monkeypatch.setattr(_build, "load", no_library)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty((1, 32, 2, 16), device="cuda")
        dt = torch.empty((1, 32, 2), device="cuda")
        A = torch.empty((2,), device="cuda")
        B = torch.empty((1, 32, 8), device="cuda")
    before = ssd_ops.bwd_launches
    with pytest.raises(RuntimeError, match="cannot build ssd"):
        ssd_ops._backward(x, dt, A, B, B, 16, x, None)
    assert not calls and ssd_ops.bwd_launches == before


@pytest.mark.parametrize("shape", [(1, 1024, 80, 128, 256),
                                   (2, 2048, 40, 128, 256),
                                   (1, 64, 2, 8, 16), (3, 100, 7, 30, 100)],
                         ids=str)
def test_backward_head_groups(shape):
    """Every head in exactly one group, every group non-empty, and the
    scratch's part counts follow the groups."""
    b, S, H, N, chunk = shape
    for size in ssd_ops.bwd_head_groups(b, S, H, N, chunk):
        groups = -(-H // size)
        assert 1 <= size <= H and (groups - 1) * size < H
    shapes = ssd_ops.bwd_scratch_shapes(b, S, H, 64, N, chunk)
    hg_dp, hg_dbc = ssd_ops.bwd_head_groups(b, S, H, N, chunk)
    assert shapes["dG_part"][0] == -(-H // hg_dp)
    assert shapes["dbc_part"][0] == -(-H // hg_dbc)
    assert list(shapes)[:4] == ["scores", "cum", "states", "prev"]
    assert len(shapes) == 16
