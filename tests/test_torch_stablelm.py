"""stablelm-3b's layout at head dim 80, the port against the JAX package on
the CPU, with the JAX package's weights handed over as numpy.

stablelm-3b (LayerNorm, partial rotary 25%, MHA 32 q / 32 kv heads of 80)
is cut in depth and width but keeps its head dim: 2 layers, 2 heads of 80,
d_model 160, d_ff 256, vocab 256 (``ModelConfig.reduced()`` would give hd
16, which every ``-smoke`` model has; the kernels' head-dim dispatch is
what this file's width is for). Both packages build it from an Imagefile's
ARCH overrides, which equal ``dataclasses.replace`` on their
``get_config("stablelm-3b")``.

* prefill logits within 1e-4 (float32; the packages sum in other orders);
* 8 greedy decode steps, contiguous and paged (a shuffled page table,
  pages of 8): identical tokens, logits within 1e-4 at every step.

On the CPU the port's attention runs its kernels' plain versions; the
kernels themselves at head dim 80 are held against those by
tests/test_torch_cuda.py and chip_smoke.py on a card.
"""

import dataclasses

import jax
import numpy as np
import pytest

import torch_parity as tp
from repro.configs import get_config as j_get_config
from repro.core.runtime import Runtime as JRuntime
from repro_torch.configs import get_config
from repro_torch.core.runtime import Runtime
from repro_torch.models.params import tree_leaves

pytestmark = pytest.mark.orchestrator

CUT = dict(n_layers=2, d_model=160, n_heads=2, n_kv_heads=2, head_dim=80,
           d_ff=256, vocab_size=256)

IMAGEFILE = """
FROM scratch
ARCH stablelm-3b {overrides}
MESH local
PRECISION compute=float32 params=float32
""".format(overrides=" ".join(f"{k}={v}" for k, v in CUT.items()))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("stevedore")
    jrt = JRuntime(root / "jax")
    jrt.build(IMAGEFILE, tag="stablelm")
    trt = Runtime(root / "torch")
    trt.build(IMAGEFILE, tag="stablelm")
    jc = jrt.run("stablelm")
    tc = trt.run("stablelm", platform="cpu")
    jparams = jc.init_params(0)
    np_params = jax.tree.map(np.asarray, jparams)
    return dict(jc=jc, tc=tc, jparams=jparams,
                tparams=tc.load_params(np_params))


def test_config_is_stablelm_cut_at_head_dim_80(env):
    j_want = dataclasses.replace(j_get_config("stablelm-3b"), **CUT)
    t_want = dataclasses.replace(get_config("stablelm-3b"), **CUT)
    assert env["jc"].arch == j_want and env["tc"].arch == t_want
    a = env["tc"].arch
    assert (a.head_dim, a.n_heads, a.n_kv_heads, a.norm, a.rope_pct) == \
        (80, 2, 2, "layernorm", 0.25)
    assert dataclasses.asdict(a) == dataclasses.asdict(env["jc"].arch)


def test_prefill_logits_match(env):
    tp.check_prefill(env)


def test_greedy_decode_contiguous(env):
    """Prefill a 12-token prompt into a 32-position slab, then 8 decode
    steps at per-row positions: the same tokens and logits."""
    tp.check_greedy_contiguous(env)


def test_greedy_decode_paged(env):
    """Two slots of different prompt lengths prefill page-major into a
    shuffled pool of (n_kv, n_pages, 8, 80) pages (through each package's
    scatter helper), then 8 paged decode steps: the same tokens and
    logits."""
    pool = env["tc"].init_paged_cache(8, 8)
    assert {t.shape[-1] for t in tree_leaves(pool)} == {80}
    tp.check_greedy_paged(env)
