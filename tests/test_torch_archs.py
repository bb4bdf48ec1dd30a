"""The whole model zoo on the port, on the CPU, at the ten archs' smoke
sizes (tests/test_archs.py's forward and parameter-count checks, re-run on
``repro_torch``), and the dense archs besides llama against the JAX
package:

* every arch's ``-smoke`` forward gives finite logits of shape (B, S,
  padded vocab) and a finite aux, frontend archs with their prefix;
* the analytic ``param_count`` tracks the port's full-size tree within 2%;
* the port's param tree equals the JAX package's leaf for leaf (shape,
  logical axes, init law, scale), for all ten ``-smoke`` configs;
* nemotron-4-15b-smoke (LayerNorm, squared ReLU, rotary on half of each
  head, a GQA group of 2 at this size) and deepseek-67b-smoke: prefill
  logits within 1e-4 (float32), 8 greedy decode steps contiguous and
  paged with identical tokens, and the 12-request Pod trace (paged,
  prefix cache on) with identical tokens (tests/torch_parity.py).
"""

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.configs import get_config as j_get_config
from repro.models.transformer import Model as JModel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.layers import padded_vocab
from repro_torch.models.params import count_params, materialize, tree_leaves
from repro_torch.models.transformer import Model

DENSE = ("nemotron-4-15b-smoke", "deepseek-67b-smoke")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_smoke(arch):
    cfg = get_config(arch).reduced()
    m = Model(cfg, tp=1)
    prm = materialize(m.param_defs(), 0)
    B, S = 2, 16
    tok_len = S - cfg.frontend_len
    tokens = torch.randint(0, cfg.vocab_size, (B, tok_len),
                           generator=torch.Generator().manual_seed(1))
    fe = (torch.full((B, cfg.frontend_len, cfg.d_model), 0.01,
                     dtype=torch.bfloat16) if cfg.frontend else None)
    with torch.no_grad():
        logits, aux = m.forward(prm, tokens, frontend_embeds=fe)
    assert tuple(logits.shape) == (B, S, padded_vocab(cfg.vocab_size))
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(aux))
    assert (float(aux) > 0) == ("moe" in cfg.layer_types())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_defs(arch):
    cfg = get_config(arch)
    real = count_params(Model(cfg, tp=1).param_defs())
    analytic = cfg.param_count()
    pad = padded_vocab(cfg.vocab_size) - cfg.vocab_size
    analytic += pad * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    assert abs(real - analytic) / analytic < 0.02, (real, analytic)


@pytest.mark.parametrize("arch", [a + "-smoke" for a in ARCH_IDS])
def test_param_tree_equals_jax_tree(arch):
    jd = JModel(j_get_config(arch)).param_defs()
    td = Model(get_config(arch)).param_defs()
    jl = jax.tree.leaves_with_path(jd, is_leaf=lambda x: hasattr(x, "init"))
    tl = tree_leaves(td)
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert (a.shape, a.logical, a.init, a.scale) == \
            (b.shape, b.logical, b.init, b.scale), jax.tree_util.keystr(path)
    assert count_params(td) == sum(int(np.prod(a.shape)) for _, a in jl)


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stevedore")
    return {arch: tp.make_env(root / arch, arch) for arch in DENSE}


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match(envs, arch):
    tp.check_prefill(envs[arch])


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_decode_contiguous(envs, arch):
    tp.check_greedy_contiguous(envs[arch])


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_decode_paged(envs, arch):
    tp.check_greedy_paged(envs[arch])


@pytest.mark.parametrize("arch", DENSE)
def test_pod_trace_tokens_identical_across_packages(envs, arch):
    tp.check_pod_trace(envs[arch], paged=True, prefix_cache=True)
