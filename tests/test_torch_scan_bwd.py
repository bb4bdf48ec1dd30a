"""The RG-LRU scan's backward routes, on the CPU.

* the reverse route of the scan's dispatch (the backward's adjoint
  recurrence dh_t = g_t + a_{t+1} dh_{t+1}) against a loop over time in
  numpy, float64, within 1e-5 of max(1, max |dh|);
* a traced smoke training step on ``meta`` counts each rec layer's
  backward as one ``rglru_scan_bwd`` call (K4's reverse scan) at
  ``cost()`` of its shape;
* with tensors that claim a card, the reverse scan builds its kernel or
  raises and never reaches the plain version.

The kernel itself runs only on a card: tests/test_torch_cuda.py. The
Function's grads against the JAX package's ``custom_vjp``:
tests/test_torch_grad.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.container import Container
from repro_torch.core.image import ImageBuilder
from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import ops as rg_ops

pytestmark = pytest.mark.kernels


@pytest.mark.parametrize("shape", [(1, 1, 3), (2, 17, 5), (1, 64, 40)],
                         ids=str)
def test_cpu_reverse_scan_is_the_adjoint_recurrence(shape):
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want = np.zeros(shape)
    carry = np.zeros((shape[0], shape[2]))
    for t in reversed(range(shape[1])):
        a_next = a[:, t + 1] if t + 1 < shape[1] else 0.0
        carry = g[:, t] + a_next * carry
        want[:, t] = carry
    before = rg_ops.launches, rg_ops.bwd_launches
    got = rg_ops._forward(torch.from_numpy(a), torch.from_numpy(g),
                          reverse=True)
    assert (rg_ops.launches, rg_ops.bwd_launches) == before
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * max(
        1.0, np.abs(want).max())


def test_meta_step_counts_the_reverse_scan():
    """recurrentgemma-2b-smoke (rec, rec, attn) traced on ``meta``: each rec
    layer's backward is one ``rglru_scan_bwd`` call at ``cost()`` of its
    shape (one reverse launch on a card), each scan forward twice under
    remat=full, the attention layer's forward twice and its backward
    kernels once."""
    from repro_torch.configs import get_config
    cfg = get_config("recurrentgemma-2b-smoke")
    S, B = 16, 2
    img = (ImageBuilder.from_scratch().arch("recurrentgemma-2b-smoke")
           .shape("train_4k", seq_len=S, global_batch=B).mesh("local")
           .precision(params="float32", compute="float32")
           .collectives("generic").set(remat="full").build())
    c = Container(img, platform="local", device="meta").lower_step("train")
    counter = c.counter
    rec = cfg.layer_types().count("rec")
    assert counter.kernel_calls == {"rglru_scan": 2 * rec,
                                    "rglru_scan_bwd": rec,
                                    "flash_attention_fwd": 2,
                                    "flash_attention_bwd": 1}
    flops, nbytes = rg_ops.cost(B, S, cfg.rnn_width_)
    assert counter.by_op["kernel:rglru_scan_bwd"] == [rec * flops,
                                                      rec * nbytes, rec]


def test_card_reverse_scan_builds_its_kernel_or_raises(monkeypatch):
    """Handed tensors on a card, the reverse scan reaches the build of its
    kernel (which raises here) and not the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs instead")
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = []
    monkeypatch.setattr(rg_ops, "rglru_scan_ref",
                        lambda *a, **kw: calls.append(1))

    def no_library(name):
        raise RuntimeError(f"cannot build {name}: no nvcc")
    monkeypatch.setattr(_build, "load", no_library)
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = torch.empty((1, 8, 32), device="cuda")
    before = rg_ops.bwd_launches
    with pytest.raises(RuntimeError, match="cannot build rglru_scan"):
        rg_ops._forward(a, a, reverse=True)
    assert not calls and rg_ops.bwd_launches == before
