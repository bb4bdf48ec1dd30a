"""The port's training path against the JAX package, on the CPU.

Both packages build one image in float32; the JAX package's seed-0
weights go to the port as numpy (``Container.load_params``), and both draw
the same ``SyntheticLM`` batches. Tolerances:

* optimizer and loss functions: 1e-6 relative (one update of the same
  float32 arithmetic);
* one train step: loss and ``grad_norm`` within 1e-4 absolute, every grad
  leaf within 1e-4 of that leaf's largest JAX value (two libraries, sums
  in other orders);
* five chained steps: every loss within 1e-4. MoE routing amplifies the
  ~1e-7 parameter differences of a step into ~5e-5 loss differences by
  step 5 on moonshot-v1-16b-a3b-smoke (a near-tie routes a row to another
  expert); from the same state each step agrees to 1e-6.

Then the JAX package's own training tests (tests/test_train.py,
test_compression.py, test_mixed_precision.py, test_archs.py) on the port,
with the bounds they state, and ``launch/train.py`` through the CLI on
the CPU: 2 steps, then ``--resume``.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.runtime import Runtime as JRuntime
from repro.train import compression as jcomp
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import lr_at as j_lr_at
from repro.train.train_step import TrainStepBuilder as JBuilder
from repro.train.train_step import cross_entropy as j_cross_entropy
from repro_torch.cli import main as tcli
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.abi import make_abi
from repro_torch.core.runtime import Runtime
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.params import materialize, tree_leaves, tree_map
from repro_torch.models.transformer import Model
from repro_torch.train.compression import (_compressible, powersgd_init,
                                           powersgd_sync)
from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update,
                                         lr_at)
from repro_torch.train.train_step import TrainStepBuilder, cross_entropy

IMAGEFILE = """
FROM scratch
ARCH {arch}
SHAPE train_4k seq_len=16 global_batch=4
MESH local
PRECISION compute=float32 params=float32
COLLECTIVES generic
SET optimizer={{"lr":0.005,"warmup_steps":2,"total_steps":50}}
"""

PARITY_ARCHS = ("llama3.2-3b-smoke", "moonshot-v1-16b-a3b-smoke",
                "mamba2-2.7b-smoke", "recurrentgemma-2b-smoke",
                "musicgen-medium-smoke")
OPT_TOL = 1e-6
STEP_TOL = 1e-4


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rel_close(j, t, tol):
    j, t = np.asarray(j, np.float32), _np(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    err = float(np.abs(j - t).max()) if j.size else 0.0
    assert err <= tol * max(float(np.abs(j).max()) if j.size else 0.0,
                            1e-30), (err, tol)


def _batches(cfg, n, B=4, S=16, seed=11):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=seed,
                                  frontend_len=cfg.frontend_len,
                                  d_model=cfg.d_model))
    return [data.batch(i) for i in range(n)]


# ---------------------------------------------------------------------------
# optimizer against JAX
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1), dict(warmup_steps=0, total_steps=50)):
        j = [float(j_lr_at(JOptConfig(**kw), jnp.int32(s)))
             for s in range(121)]
        t = [float(lr_at(OptConfig(**kw), s)) for s in range(121)]
        np.testing.assert_allclose(t, j, rtol=OPT_TOL, atol=0)


def _random_tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((8, 16)).astype(dtype),
            "nested": {"b": rng.standard_normal(16).astype(dtype),
                       "k": rng.standard_normal((2, 3, 4)).astype(dtype)}}


@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_matches_jax(master):
    """Two updates (bias corrections at steps 0 and 1), clip engaged on the
    second; with ``master`` the params are bfloat16 over a float32
    master."""
    rng = np.random.default_rng(0)
    p = _random_tree(rng)
    grads = [_random_tree(rng), jax.tree.map(lambda a: 50 * a,
                                             _random_tree(rng))]
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, p)
    tp = tree_map(torch.from_numpy, p)
    if master:
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = tree_map(lambda a: a.to(torch.bfloat16), tp)
    jst, tst = j_adamw_init(jp, master), adamw_init(tp, master)
    for g in grads:
        jp, jst, jm = j_adamw_update(jp, jax.tree.map(jnp.asarray, g), jst,
                                     JOptConfig(**cfg))
        tp, tst, tm = adamw_update(tp, tree_map(torch.from_numpy, g),
                                   tst, OptConfig(**cfg))
        for k in ("grad_norm", "lr"):
            _rel_close(jm[k], tm[k], OPT_TOL)
    assert int(tst["step"]) == 2 and set(tst) == set(jst)
    for key in ("m", "v") + (("master",) if master else ()):
        for a, b in zip(jax.tree.leaves(jst[key]), tree_leaves(tst[key])):
            _rel_close(a, b, OPT_TOL)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert b.dtype == (torch.bfloat16 if master else torch.float32)
        # bf16 params: one bf16 rounding of the same master
        _rel_close(a.astype(jnp.float32), b,
                   2.0 ** -8 if master else OPT_TOL)


def test_inplace_update_equals_functional():
    rng = np.random.default_rng(1)
    p = tree_map(torch.from_numpy, _random_tree(rng))
    g = tree_map(torch.from_numpy, _random_tree(rng))
    st = adamw_init(p)
    fp, fst, _ = adamw_update(p, g, st, OptConfig(lr=1e-2))
    assert int(st["step"]) == 0                  # inputs untouched
    ip, ist, _ = adamw_update(p, g, st, OptConfig(lr=1e-2), inplace=True)
    assert ip["w"] is p["w"] and int(st["step"]) == 1
    for a, b in zip(tree_leaves(fp) + tree_leaves(fst["m"]),
                    tree_leaves(ip) + tree_leaves(ist["m"])):
        assert torch.equal(a, b)


def test_grad_clip_engages():
    opt = OptConfig(lr=1e-2, grad_clip=1.0)
    p = {"w": torch.ones(4)}
    st = adamw_init(p)
    p1, _, m1 = adamw_update(p, {"w": torch.full((4,), 0.1)}, st, opt)
    p2, _, m2 = adamw_update(p, {"w": torch.full((4,), 1e3)}, st, opt)
    assert float(m2["grad_norm"]) > float(m1["grad_norm"])
    assert torch.isfinite(p2["w"]).all()
    assert float((p2["w"] - p["w"]).abs().max()) < 0.05


def test_weight_decay_pulls_to_zero():
    opt = OptConfig(lr=1e-1, weight_decay=1.0, warmup_steps=0)
    p = {"w": torch.full((4,), 10.0)}
    p2, _, _ = adamw_update(p, {"w": torch.zeros(4)}, adamw_init(p), opt)
    assert float(p2["w"][0]) < 10.0


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax_with_padding_and_mask():
    rng = np.random.default_rng(2)
    B, S, V, Vp = 2, 5, 10, 16
    logits = rng.standard_normal((B, S, Vp)).astype(np.float32)
    logits[..., V:] = 1e9                        # junk in the padding
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.4).astype(np.float32)
    for m in (None, mask, np.zeros((B, S), np.float32)):
        j = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), V,
                            None if m is None else jnp.asarray(m))
        t = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          V, None if m is None else torch.from_numpy(m))
        assert np.isfinite(float(t))
        assert abs(float(j) - float(t)) <= OPT_TOL * max(1.0, abs(float(j)))
    uniform = cross_entropy(torch.zeros(B, S, Vp), torch.zeros(B, S,
                            dtype=torch.int32), V)
    assert abs(float(uniform) - np.log(V)) < 1e-3


# ---------------------------------------------------------------------------
# train steps against JAX
# ---------------------------------------------------------------------------

def _envs(root, arch):
    jrt, trt = JRuntime(root / "jax"), Runtime(root / "torch")
    jrt.build(IMAGEFILE.format(arch=arch), tag="s")
    trt.build(IMAGEFILE.format(arch=arch), tag="s")
    jc, tc = jrt.run("s"), trt.run("s", platform="cpu")
    jp = jc.init_params(0)
    return jc, tc, jp, tc.load_params(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_train_step_matches_jax(tmp_path, arch):
    jc, tc, jp, tp = _envs(tmp_path, arch)
    batches = _batches(jc.arch, 5)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    builder = JBuilder(model=jc.model, mesh=jc.mesh, rules=jc.rules,
                       abi=jc.abi, opt=jc.opt)
    jg, jl, ja = jax.jit(builder._grads)(jp, jb)
    tb = TrainStepBuilder(model=tc.model, abi=tc.abi, opt=tc.opt)
    tg, tl, ta = tb._grads(tp, {k: torch.as_tensor(v) for k, v in
                                batches[0].items()})
    assert abs(float(jl) - float(tl)) <= STEP_TOL
    assert abs(float(ja) - float(ta)) <= STEP_TOL
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        _rel_close(a, b, STEP_TOL)

    jstep, tstep = jax.jit(jc.train_step_fn()), tc.train_step_fn()
    jo, to = jc.init_opt_state(jp), tc.init_opt_state(tp)
    for i, b in enumerate(batches):
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, b)
        assert set(tm) == set(jm)
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= STEP_TOL, i
        assert abs(float(jm["aux_loss"]) - float(tm["aux_loss"])) \
            <= STEP_TOL, i
        if i == 0:
            assert abs(float(jm["grad_norm"]) - float(tm["grad_norm"])) \
                <= STEP_TOL
    assert int(to["step"]) == 5


def _smoke(arch="llama3.2-3b-smoke"):
    cfg = get_config(arch)
    m = Model(cfg, act_dtype=torch.float32)
    return cfg, m, materialize(m.param_defs(), 0)


def _step(m, abi=None, opt=None, **kw):
    return TrainStepBuilder(model=m, abi=abi or make_abi("generic"),
                            opt=opt or OptConfig(lr=1e-2, warmup_steps=2,
                                                 total_steps=100),
                            **kw).build()


def _max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


def test_grad_accum_equivalence():
    cfg, m, prm = _smoke()
    batch = _batches(cfg, 1, B=8, seed=3)[0]
    outs = {mb: _step(m, microbatches=mb)(prm, adamw_init(prm), batch)
            for mb in (1, 2)}
    assert abs(float(outs[2][2]["loss"]) - float(outs[1][2]["loss"])) < 1e-4
    assert _max_diff(outs[1][0], outs[2][0]) < 1e-4


def test_abi_generic_vs_host_parity_and_bf16_wire():
    cfg, m, prm = _smoke()
    batch = _batches(cfg, 1, seed=3)[0]
    res = {}
    for name, abi in (
            ("generic", make_abi("generic")),
            ("host", make_abi("host", zero1=False,
                              grad_compression="float32", hierarchical=True,
                              mode="explicit")),
            ("bf16", make_abi("host", zero1=False,
                              grad_compression="bfloat16",
                              hierarchical=False, mode="explicit"))):
        res[name] = _step(m, abi)(prm, adamw_init(prm), batch)
    assert abs(float(res["generic"][2]["loss"])
               - float(res["host"][2]["loss"])) < 1e-5
    assert _max_diff(res["generic"][0], res["host"][0]) < 1e-5
    # one process: the wire dtype is a round trip through bfloat16
    assert 0 < _max_diff(res["host"][0], res["bf16"][0]) < 5e-2


def test_world_one_sync_is_identity_and_unported_settings_raise(
        monkeypatch, tmp_path):
    """On one process the ABI's mean is the identity (a cast to the wire
    dtype and back), and FSDP splits nothing: its step equals the step
    without it, bit for bit. Multi-process data and tensor parallelism and
    FSDP are ported, and nothing of them raises any longer: an MoE arch on
    several batch replicas without a model axis builds with its dispatch
    over the global batch of the replicas (``Model.moe_replicas``, the
    reference's capacity there). A mesh (the pod platforms included)
    needs as many ranks as it has devices, as ``jax.make_mesh`` does."""
    from repro_torch.dist.mesh import make_mesh
    g = {"w": torch.linspace(-1, 1, 7)}
    host = make_abi("host", mode="explicit")
    out = host.grad_sync(g, ("data",))
    assert out["w"].dtype == torch.float32
    assert torch.equal(out["w"], g["w"].to(torch.bfloat16).float())
    st = powersgd_init(g, 2)
    assert torch.equal(powersgd_sync(g, st, ("data",), 2)[0]["w"], g["w"])

    rt = Runtime(tmp_path / "rt")
    rt.build(IMAGEFILE.format(arch="llama3.2-3b-smoke")
             + "SET fsdp=true\n", tag="fsdp")
    rt.build(IMAGEFILE.format(arch="llama3.2-3b-smoke"), tag="plain")
    batch = SyntheticLM(DataConfig(vocab_size=256, seq_len=16,
                                   global_batch=4, seed=1)).batch(0)
    runs = []
    for tag in ("fsdp", "plain"):
        c = rt.run(tag, platform="cpu")
        assert c.model.fsdp is None
        params = c.init_params(0)
        runs.append(c.train_step_fn()(params, c.init_opt_state(params),
                                      batch))
    (p1, _, m1), (p2, _, m2) = runs
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1),
                                                 tree_leaves(p2)))
    with pytest.raises(ValueError, match="needs 2 ranks; this job has 1"):
        make_mesh((1, 2), ("data", "model"))
    rt.build(IMAGEFILE.format(arch="llama3.2-3b-smoke"), tag="dense")
    for platform, n in (("pod", 256), ("multipod", 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            rt.run("dense", platform=platform)
    rt.build(IMAGEFILE.format(arch="moonshot-v1-16b-a3b-smoke"), tag="moe")
    assert rt.run("moe", platform="cpu").mesh.size == 1
    # a job of two ranks, as this process sees it (the local mesh of two
    # ranks on data needs no process group of its own)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    from repro_torch.dist.mesh import PlatformMesh
    # the container id is rank 0's (no rank 1 answers here)
    monkeypatch.setattr(PlatformMesh, "broadcast_object",
                        lambda self, obj: obj)
    from repro_torch.dist.sharding import replicas_of
    c = rt.run("moe", platform="cpu")
    reps = replicas_of(c.mesh)
    assert reps.size == 2 and c.model.moe_replicas(reps) is reps
    assert rt.run("dense", platform="cpu").model.moe_replicas(reps) is None


def test_loss_decreases():
    cfg, m, prm = _smoke()
    step = _step(m, donate=True)
    st = adamw_init(prm)
    losses = []
    for b in _batches(cfg, 25, B=8, seed=3):
        prm, st, metrics = step(prm, st, b)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[:3] + losses[-3:]


def test_restart_determinism():
    cfg, m, prm = _smoke()
    step = _step(m)
    st = adamw_init(prm)
    b = _batches(cfg, 1, seed=3)[0]
    p1, _, _ = step(prm, st, b)
    p1b, _, _ = step(prm, st, b)
    assert _max_diff(p1, p1b) == 0.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    """tests/test_archs.py::test_train_step_smoke on the port: every arch's
    smoke reduction, bf16 compute, one step: finite loss and grad norm,
    params moved, step 1."""
    cfg = get_config(arch).reduced()
    m = Model(cfg)
    prm = materialize(m.param_defs(), 0)
    step = _step(m, opt=OptConfig(lr=1e-3, warmup_steps=1))
    rng = np.random.default_rng(1)
    tok_len = 16 - cfg.frontend_len
    batch = {k: rng.integers(0, cfg.vocab_size, (2, tok_len))
             for k in ("tokens", "labels")}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.full(
            (2, cfg.frontend_len, cfg.d_model), 0.01, dtype=torch.bfloat16)
    new_prm, new_opt, metrics = step(prm, adamw_init(prm), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert 0 < float(metrics["grad_norm"]) < float("inf")
    assert _max_diff(prm, new_prm) > 0
    assert int(new_opt["step"]) == 1


# ---------------------------------------------------------------------------
# PowerSGD and master weights (test_compression.py, test_mixed_precision.py)
# ---------------------------------------------------------------------------

def test_compressible_predicate_matches_jax():
    for shape, r in (((256, 256), 4), ((256,), 4), ((8, 8), 4),
                     ((64, 4, 32), 4), ((16, 1024), 16)):
        assert _compressible(torch.zeros(shape), r) == \
            jcomp._compressible(jnp.zeros(shape), r)


def test_powersgd_rank_r_recovered_and_error_feedback():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((64, 4)), rng.standard_normal((96, 4))
    g = {"w": torch.from_numpy((a @ b.T).astype(np.float32))}
    st = powersgd_init(g, 4)
    for _ in range(3):
        out, st = powersgd_sync(g, st, (), 4)
    assert float((out["w"] - g["w"]).abs().max()) < 1e-3
    assert float(st["err"]["w"].abs().max()) < 1e-3
    # EF identity: sum(transmitted) + error_k == k * G
    g = {"w": torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32))}
    st = powersgd_init(g, 2)
    total = torch.zeros_like(g["w"])
    for _ in range(10):
        out, st = powersgd_sync(g, st, (), 2)
        total += out["w"]
    rel = float(torch.linalg.norm(total + st["err"]["w"] - 10 * g["w"])
                / torch.linalg.norm(10 * g["w"]))
    assert rel < 1e-4, rel


def test_powersgd_sync_matches_jax_from_the_same_q():
    """One sync from the same Q and error buffer: the same compressed
    gradient, new Q and new error (up to the sign QR picks per column,
    which both libraries fix the same way on the CPU)."""
    rng = np.random.default_rng(4)
    g = {"w": rng.standard_normal((48, 40)).astype(np.float32),
         "b": rng.standard_normal(40).astype(np.float32)}
    q = np.linalg.qr(rng.standard_normal((40, 4)))[0].astype(np.float32)
    e = rng.standard_normal((48, 40)).astype(np.float32) * 0.1
    jout, jst = jcomp.powersgd_sync(
        jax.tree.map(jnp.asarray, g),
        {"q": {"w": jnp.asarray(q), "b": None},
         "err": {"w": jnp.asarray(e), "b": None}}, (), 4)
    tout, tst = powersgd_sync(
        tree_map(torch.from_numpy, g),
        {"q": {"w": torch.from_numpy(q), "b": None},
         "err": {"w": torch.from_numpy(e), "b": None}}, (), 4)
    for k in ("w", "b"):
        _rel_close(jout[k], tout[k], 1e-4)
    _rel_close(jst["err"]["w"], tst["err"]["w"], 1e-4)
    assert tst["q"]["b"] is None and tst["err"]["b"] is None


def test_training_with_powersgd_converges(tmp_path):
    trt = Runtime(tmp_path / "rt")
    trt.build(IMAGEFILE.format(arch="llama3.2-3b-smoke").replace(
        "COLLECTIVES generic", "COLLECTIVES host mode=explicit zero1=false "
        "grad_compression=float32 hierarchical=false compression=powersgd "
        "rank=8"), tag="p")
    c = trt.run("p", platform="cpu")
    prm = c.init_params(0)
    st = c.init_opt_state(prm)
    assert set(st["comm"]) == {"q", "err"}
    step = c.train_step_fn(donate=True)
    losses = []
    for b in _batches(c.arch, 20, B=8, seed=3):
        prm, st, metrics = step(prm, st, b)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses
    # the comm state keeps the abstract template's shapes
    tmpl = c.abstract_opt_state()["comm"]
    for a, b in zip(tree_leaves(tmpl["err"]), tree_leaves(st["comm"]["err"])):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape


def test_master_weights_match_f32_training():
    cfg, m, p32 = _smoke()
    pbf = tree_map(lambda x: x.to(torch.bfloat16), p32)
    step = _step(m, opt=OptConfig(lr=5e-3, warmup_steps=1, total_steps=50))
    st32, stbf = adamw_init(p32), adamw_init(pbf, with_master=True)
    l32, lbf = [], []
    for b in _batches(cfg, 8, seed=5):
        p32, st32, m1 = step(p32, st32, b)
        pbf, stbf, m2 = step(pbf, stbf, b)
        l32.append(float(m1["loss"]))
        lbf.append(float(m2["loss"]))
    assert abs(l32[-1] - lbf[-1]) < 0.05, (l32, lbf)
    assert tree_leaves(pbf)[0].dtype == torch.bfloat16
    assert tree_leaves(stbf["master"])[0].dtype == torch.float32


def test_master_weights_avoid_bf16_stall():
    p = {"w": torch.ones(8, dtype=torch.bfloat16)}
    opt = OptConfig(lr=1e-4, warmup_steps=0, weight_decay=0.0, grad_clip=1e9)
    g = {"w": torch.full((8,), 1e-3)}
    p_plain, p_master = p, p
    st_plain, st_master = adamw_init(p), adamw_init(p, with_master=True)
    for _ in range(64):
        p_plain, st_plain, _ = adamw_update(p_plain, g, st_plain, opt)
        p_master, st_master, _ = adamw_update(p_master, g, st_master, opt)
    assert float(p_plain["w"][0]) == 1.0        # bf16 swallows each step
    assert float((st_master["master"]["w"] - 1.0).abs().max()) > 1e-4
    assert float((p_master["w"].float() - 1.0).abs().max()) > 0


# ---------------------------------------------------------------------------
# launch/train.py through the CLI (tests/test_system.py's workflow)
# ---------------------------------------------------------------------------

def _run(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli(list(argv)) == 0
    return out.getvalue()


def test_cli_run_then_resume_continues(tmp_path):
    f = tmp_path / "Imagefile"
    f.write_text(IMAGEFILE.format(arch="llama3.2-3b-smoke"))
    root = str(tmp_path / "rt")
    _run("--root", root, "build", "-t", "s", str(f))
    out = _run("--root", root, "run", "s", "--platform", "cpu", "--steps",
               "4", "--ckpt-every", "2")
    assert "step 1 loss=" in out and "done at step 4" in out
    out = _run("--root", root, "run", "s", "--platform", "cpu", "--steps",
               "2", "--resume")
    assert "resumed from step 4" in out and "done at step 6" in out
    # the resumed step 5 equals step 5 of a straight 6-step run
    straight = _run("--root", str(tmp_path / "rt2"), "run", str(f),
                    "--platform", "cpu", "--steps", "6")
    assert "done at step 6" in straight

    def step_losses(root_dir):
        recs = [json.loads(ln) for p in sorted((tmp_path / root_dir)
                .glob("overlays/*/metrics.jsonl"))
                for ln in p.read_text().splitlines()]
        return {r["step"]: r["loss"] for r in recs}

    resumed, full = step_losses("rt"), step_losses("rt2")
    assert set(full) == set(range(1, 7)) and set(resumed) == set(full)
    for s in range(1, 7):
        assert resumed[s] == pytest.approx(full[s], abs=1e-6), s


def test_cli_run_needs_a_card_unless_the_cpu_is_asked_for(tmp_path,
                                                          monkeypatch):
    """No fallback: without CUDA the default platform raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = tmp_path / "Imagefile"
    f.write_text(IMAGEFILE.format(arch="llama3.2-3b-smoke"))
    root = str(tmp_path / "rt")
    _run("--root", root, "build", "-t", "s", str(f))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli(["--root", root, "run", "s", "--steps", "1"])


def test_keep_bounds_the_checkpoints_on_disk(tmp_path):
    f = tmp_path / "Imagefile"
    f.write_text(IMAGEFILE.format(arch="llama3.2-3b-smoke"))
    root = tmp_path / "rt"
    _run("--root", str(root), "build", "-t", "s", str(f))
    _run("--root", str(root), "run", "s", "--platform", "cpu", "--steps",
         "4", "--ckpt-every", "1", "--keep", "1")
    (ckpt,) = root.glob("overlays/*/ckpt")
    assert [p.name for p in (ckpt / "manifests").iterdir()] == \
        ["step-0000000004.json"]
