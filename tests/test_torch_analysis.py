"""The port's roofline analysis (``repro_torch.launch.analysis``) and the
kernels' ``cost()``, on the CPU, against the JAX package's
``repro.launch.analysis`` and the kernel rows of PERF.md.

* tests/test_analysis.py's bodies that parse no HLO, on the port's
  module: collective stats scaled, both ``model_flops`` tests, and the
  roofline terms at the H100 constants;
* ``model_flops`` equal to the reference's for every arch x shape cell,
  and ``skip_reason`` equal to the reference dry run's (exactly);
* every group of the ``multipod`` mesh classified cross-pod exactly as the
  reference's ``_crosses_pod`` classifies the same groups written as
  ``replica_groups``; a collective over a cross-pod group counted so;
* each kernel's ``cost()`` reproducing PERF.md's kernel rows (exactly, at
  the printed precision);
* the counter: views count no bytes, a kernel wrapper adds its cost in
  place of its plain version's operators, and a ``meta`` tensor takes the
  kernel route only inside a counter (outside one it still raises).
"""

import itertools
import os

import numpy as np
import pytest
import torch

import repro.launch.analysis as ref
from repro.configs import ARCH_IDS as REF_ARCH_IDS, get_config as ref_config
from repro.models.config import SHAPE_CELLS as REF_CELLS
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.trace import Counter
from repro_torch.dist.mesh import (CollectiveStats, POD_SIZE, collective,
                                   fake_job, make_mesh)
from repro_torch.kernels import _launch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import analysis
from repro_torch.launch.analysis import (Cost, PEAK_FLOPS, HBM_BW,
                                         model_flops, roofline)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPE_CELLS, get_shape_cell


# -- (1) tests/test_analysis.py's bodies on the port -------------------------

def test_collective_stats_add_scales():
    """Mirrors test_analysis.py::test_collective_stats_add_scales (the
    port's stats keep bytes by label; ``merge`` is the reference's
    ``add``)."""
    a = CollectiveStats(bytes={"generic": {"all_reduce": 10}},
                        count_by_op={"all_reduce": 1}, cross_pod_bytes=4)
    b = CollectiveStats(bytes={"generic": {"all_reduce": 3},
                               "host": {"all_gather": 7}},
                        count_by_op={"all_reduce": 1, "all_gather": 2},
                        cross_pod_bytes=1)
    a.merge(b, scale=5)
    assert a.bytes_by_op == {"all_reduce": 25, "all_gather": 35}
    assert a.count_by_op == {"all_reduce": 6, "all_gather": 10}
    assert a.cross_pod_bytes == 9
    assert a.wire_bytes() == 60


def test_model_flops_train_vs_decode():
    """Mirrors test_analysis.py::test_model_flops_train_vs_decode."""
    cfg = get_config("llama3.2-3b")
    train = model_flops(cfg, get_shape_cell("train_4k"))
    decode = model_flops(cfg, get_shape_cell("decode_32k"))
    assert train / decode == pytest.approx(
        (6 * 256 * 4096) / (2 * 128), rel=1e-6)


def test_model_flops_moe_uses_active_params():
    """Mirrors test_analysis.py::test_model_flops_moe_uses_active_params."""
    cfg = get_config("moonshot-v1-16b-a3b")
    cell = get_shape_cell("train_4k")
    full_n = cfg.param_count(active_only=False)
    act_n = cfg.param_count(active_only=True)
    assert act_n < 0.4 * full_n              # 6 of 64 experts active
    mf = model_flops(cfg, cell)
    assert mf < 6 * full_n * cell.global_batch * cell.seq_len


def test_roofline_dominant_and_fraction():
    """Mirrors test_analysis.py::test_roofline_dominant_and_fraction at the
    H100 constants: one second of bf16 peak work, two of HBM traffic."""
    assert (PEAK_FLOPS["bfloat16"], HBM_BW) == (989e12, 3.35e12)
    cost = Cost(flops=989e12, bytes_accessed=3.35e12 * 2,
                collectives=CollectiveStats(bytes={"generic":
                                                   {"all_reduce": 0}}))
    rl = roofline(cost, model_flops_global=989e12 * 256, n_devices=256)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(2.0)
    assert rl.dominant == "memory"
    assert rl.roofline_fraction == pytest.approx(0.5)
    assert rl.useful_flops_fraction == pytest.approx(1.0)
    # a collective term: 100 GB on the 50 GB/s wire budget
    cost.collectives = CollectiveStats(bytes={"tp": {"all_reduce": 100e9}})
    rl = roofline(cost, 989e12 * 256, 256)
    assert rl.collective_s == pytest.approx(2.0)


# -- (2) model_flops and skip_reason against the reference -------------------

@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference dry run's module: importing it sets XLA_FLAGS for
    512 host devices, which later subprocesses of this worker must not
    inherit, so the variable is put back."""
    old = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def test_model_flops_and_skip_reason_match_reference(ref_dryrun):
    """Every arch x shape cell: equal floats (exact), equal skips."""
    from repro_torch.launch.dryrun import skip_reason
    assert ARCH_IDS == REF_ARCH_IDS
    assert sorted(SHAPE_CELLS) == sorted(REF_CELLS)
    for arch, shape in itertools.product(ARCH_IDS, SHAPE_CELLS):
        assert model_flops(get_config(arch), SHAPE_CELLS[shape]) == \
            ref.model_flops(ref_config(arch), REF_CELLS[shape]), (arch, shape)
        assert skip_reason(arch, shape) == ref_dryrun.skip_reason(
            arch, shape), (arch, shape)
        for tok in (1, 4096.0):
            assert model_flops(get_config(arch), SHAPE_CELLS[shape], tok) \
                == ref.model_flops(ref_config(arch), REF_CELLS[shape], tok)


# -- (3) cross-pod classification ---------------------------------------------

def _axis_sets(mesh):
    return [k for n in range(1, len(mesh.axis_names) + 1)
            for k in itertools.combinations(mesh.axis_names, n)]


def test_cross_pod_groups_match_reference():
    """Each set of the multipod mesh's axes: its groups, written as HLO
    ``replica_groups``, cross a pod for ``_crosses_pod`` exactly when the
    port says so; the pod mesh never crosses."""
    mesh = make_production_mesh(multi_pod=True)
    seen = set()
    for axes in _axis_sets(mesh):
        groups = mesh.group_lists(axes)
        assert sorted(r for g in groups for r in g) == list(range(512))
        line = "replica_groups={" + ",".join(
            "{" + ",".join(map(str, g)) + "}" for g in groups) + "}"
        want = ref._crosses_pod(line, 512, POD_SIZE)
        assert mesh.crosses_pod(axes) == want, axes
        seen.add(want)
    assert seen == {True, False}
    pod = make_production_mesh()
    assert not any(pod.crosses_pod(a) for a in _axis_sets(pod))


def test_collective_counts_cross_pod_bytes():
    """In a job of 512 fake ranks on the multipod mesh, a collective over
    the pod axis is counted as cross-pod, one over data is not."""
    with fake_job(512):
        mesh = make_mesh((2, 16, 16), ("pod", "data", "model"))
        x = torch.empty(1024, device="meta")
        collective(mesh, "generic", "all_reduce", x, x,
                   mesh.group(("data",)))
        assert mesh.stats.cross_pod_bytes == 0
        collective(mesh, "host", "all_reduce", x, x,
                   mesh.group(("pod",)))
        assert mesh.stats.cross_pod_bytes == 2 * 4096
        assert mesh.stats.count_by_op == {"all_reduce": 2}
        assert mesh.stats.wire_bytes() == 4 * 4096


# -- (4) each kernel's cost() against PERF.md's rows ---------------------------

def test_kernel_costs_reproduce_perf_rows():
    """PERF.md section 6: K1 30.71 MB of live K+V at K1_SHAPE (8 slots,
    lengths 1, 2048 and six from seed 0, a 129-page table, bf16); K2 at
    llama3.2-3b's 512-token prefill (bf16: 8.39 MB, bound 0.0025 ms by
    bytes); K3 25.77 GFLOP at 512 x 3072 x 8192; K4 70.78 MB at (1, 2304,
    2560); K5 2.033 GFLOP at (1, 512, 80, 64, 128), chunk 256."""
    rng = np.random.default_rng(0)
    lengths = np.concatenate([[1, 2048], rng.integers(2, 2048, 6)])
    mp = max(-(-int(n) // 16) for n in lengths) + 1
    assert mp == 129
    k1_flops, k1_bytes = pa_ops.cost(8, 24, 8, 128, 16, mp, lengths, 2)
    assert round(k1_bytes / 1e6, 2) == 30.71
    assert k1_flops == 4.0 * 24 * 128 * int(lengths.sum())
    assert analysis.bound_ms(k1_bytes, k1_flops, "bfloat16")[1] == "bytes"
    # a meta trace has no lengths: every slot counted full
    assert pa_ops.cost(8, 24, 8, 128, 16, mp, None, 2)[1] > k1_bytes

    k2_flops, k2_bytes = fa_ops.cost(1, 24, 8, 512, 512, 128, 2)
    assert k2_bytes == (2 * 24 + 2 * 8) * 512 * 128 * 2
    assert k2_flops == 4.0 * 24 * 128 * (512 * 513 // 2)
    ms, by = analysis.bound_ms(k2_bytes, k2_flops, "bfloat16")
    assert (round(ms, 4), by) == (0.0025, "bytes")
    # windowed: recurrentgemma's 2304-token prefill keeps 2048 keys a row
    w = fa_ops.cost(1, 10, 1, 2304, 2304, 256, 2, window=2048)[0]
    assert w == 4.0 * 10 * 256 * sum(min(i + 1, 2048) for i in range(2304))

    k3_flops, k3_bytes = mm_ops.cost(512, 8192, 3072, 2)
    assert round(k3_flops / 1e9, 2) == 25.77
    assert k3_bytes == (512 * 3072 + 3072 * 8192 + 512 * 8192) * 2

    k4_flops, k4_bytes = rg_ops.cost(1, 2304, 2560)
    assert round(k4_bytes / 1e6, 2) == 70.78
    assert k4_flops == 2.0 * 2304 * 2560

    k5_flops, k5_bytes = ssd_ops.cost(1, 512, 80, 64, 128, 256)
    assert round(k5_flops / 1e9, 3) == 2.033
    assert k5_bytes == 4 * (2 * 512 * 80 * 64 + 512 * 80 + 80
                            + 2 * 512 * 128 + 80 * 128 * 64)


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_backward_costs_reproduce_perf_rows(kernel):
    """PERF.md section 6's backward bounds at the train phase's shapes:
    K4's whole backward at (1, 2048, 2560) moves a, h and the cotangent
    in and da, db out (104.86 MB, 0.0313 ms by bytes); K5's at (1, 1024,
    80, 64, 128), chunk 256, does twice the chunked forward's operations
    (8.131 GFLOP, 0.1214 ms at the float32 FMA rate)."""
    if kernel == "K4":
        flops, nbytes = rg_ops.cost_bwd(1, 2048, 2560)
        assert nbytes == 5 * 2048 * 2560 * 4
        assert round(nbytes / 1e6, 2) == 104.86
        assert flops == 1.5 * rg_ops.cost(1, 2048, 2560)[0]
        want = (0.0313, "bytes")
    else:
        flops, nbytes = ssd_ops.cost_bwd(1, 1024, 80, 64, 128, 256)
        assert flops == 2 * ssd_ops.cost(1, 1024, 80, 64, 128, 256)[0]
        assert round(flops / 1e9, 3) == 8.131
        # the forward's inputs and the cotangents in, their grads out
        assert nbytes == 4 * (3 * 1024 * 80 * 64 + 2 * (1024 * 80 + 80)
                              + 4 * 1024 * 128 + 80 * 128 * 64)
        want = (0.1214, "operations")
    ms, by = analysis.bound_ms(nbytes, flops, "float32")
    assert (round(ms, 4), by) == want


# -- the counter -------------------------------------------------------------------

def test_counter_counts_ops_views_and_kernels():
    """A matmul's FLOPs (FlopCounterMode's 2MNK) and bytes; a view's
    none; a kernel wrapper's cost() in place of its plain version's
    operators, on the CPU and on meta alike; the peak of live bytes."""
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    with Counter() as c:
        y = a @ b
        y.view(16, 64)
    assert c.flops == 2 * 64 * 32 * 16
    assert c.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert c.peak == 64 * 16 * 4 and c.kernel_calls == {}
    x = torch.randn(1, 64, 128)
    for dev in ("cpu", "meta"):
        xd = x.to(dev)
        with Counter() as c:
            h = rg_ops.rglru_scan(xd, xd)
        assert h.device.type == dev and h.shape == x.shape
        assert c.kernel_calls == {"rglru_scan": 1}
        assert (c.flops, c.bytes) == rg_ops.cost(1, 64, 128)
    assert _launch.active() is None


def test_meta_takes_the_kernel_route_only_inside_a_counter():
    """Outside a counter a meta tensor has no kernel (the hygiene rule);
    inside one the wrapper returns the kernel's output shape, and attend
    takes the flash kernel's route on meta (a trace stands for the card)
    and the plain one on the CPU."""
    from repro_torch.models.attention import attend
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fa_ops.flash_attention(q, q, q)
    with Counter() as c:
        assert fa_ops.flash_attention(q, q, q).shape == q.shape
    assert c.kernel_calls == {"flash_attention_fwd": 1}
    for dev, calls in (("meta", {"flash_attention_fwd": 1}), ("cpu", {})):
        qs = torch.zeros(1, 8, 2, 16, device=dev)
        pos = torch.arange(8, dtype=torch.int32, device=dev)[None]
        with Counter() as c:
            assert attend(qs, qs, qs, pos, pos).shape == qs.shape
        assert c.kernel_calls == calls
