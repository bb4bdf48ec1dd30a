"""Import and device hygiene of the PyTorch port.

* every ``repro_torch`` module imports without jax, without the JAX package
  ``repro`` and without triton (a host without triton or nvcc must import it);
* no source line of the port, ``chip_smoke.py`` or ``chip_profile.py``
  imports jax or repro;
* the default platform is the card: without CUDA, ``Runtime.run`` raises
  unless the caller asks for ``platform="cpu"``;
* a kernel wrapper handed non-CPU tensors launches its kernel or raises --
  it never falls back to the plain version;
* ``attend`` with bfloat16 scores (the reference's XLA score chain, not a
  kernel) agrees with the JAX package's on the CPU.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"})


def test_every_port_module_imports_without_jax_repro_or_triton():
    mods = _modules()
    assert len(mods) > 30
    res = _run(f"""
        import builtins, importlib, sys
        real_import = builtins.__import__
        def guarded(name, *a, **k):
            if name.split(".")[0] == "triton":
                raise ImportError("no triton here")
            return real_import(name, *a, **k)
        builtins.__import__ = guarded
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
        print("BAD", bad)
        assert not bad, bad
    """)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], (ast.Constant, ast.JoinedStr)):
            src = ast.unparse(node.args[0])
            yield node.lineno, src.strip("'\"f")


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "chip_profile.py"]
    offenders = []
    for f in files:
        for line, name in _imported_names(f):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                offenders.append(f"{f.relative_to(REPO)}:{line} {name}")
    assert not offenders, offenders


IMAGEFILE = """
FROM scratch
ARCH llama3.2-3b-smoke
MESH local
PRECISION compute=float32 params=float32
"""


def test_runtime_run_needs_cuda_unless_cpu_is_asked(tmp_path):
    from repro_torch.core.runtime import Runtime
    from repro_torch.dist.mesh import resolve_device
    rt = Runtime(tmp_path / "rt")
    rt.build(IMAGEFILE, tag="stable")
    if torch.cuda.is_available():
        assert rt.run("stable").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rt.run("stable")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("local")
    c = rt.run("stable", platform="cpu")
    assert c.device == torch.device("cpu")
    params = c.init_params(0)
    assert params["embed"]["tokens"].device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown platform"):
        rt.run("stable", platform="tpu")
    # the JAX package's pod meshes are known, and need their 256 ranks
    with pytest.raises(ValueError, match="needs 256 ranks; this job has 1"):
        rt.run("stable", platform="pod")


def _fake_cuda(*shapes_dtypes):
    """Tensors that claim to live on cuda:0, made without a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return [torch.empty(s, dtype=d, device="cuda") for s, d in shapes_dtypes]


def test_paged_wrapper_with_cuda_tensors_never_falls_back(monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs instead")
    fake = _fake_cuda(((2, 4, 16), torch.float32),
                      ((2, 5, 8, 16), torch.float32),
                      ((2, 5, 8, 16), torch.float32),
                      ((2, 3), torch.int32), ((2,), torch.int32))
    assert fake[0].device.type == "cuda"
    calls = []
    monkeypatch.setattr(ops, "paged_attention_ref",
                        lambda *a, **k: calls.append(1))

    def no_library(name):
        raise RuntimeError(f"cannot build {name}: no nvcc")
    monkeypatch.setattr(_build, "load", no_library)
    before = ops.launches
    with pytest.raises(RuntimeError, match="cannot build"):
        ops.paged_attention(*fake)
    assert not calls and ops.launches == before
    # the wrapper's own checks run before any build or launch
    with pytest.raises(ValueError, match="must be on"):
        ops.paged_attention_cuda(torch.zeros(2, 4, 16), *fake[1:])
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention_cuda(*fake[:3], *_fake_cuda(
            ((2, 3), torch.int64), ((2,), torch.int32)))


def test_flash_wrapper_with_cuda_tensors_never_falls_back(monkeypatch):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs instead")
    q, k, v = _fake_cuda(((1, 4, 8, 16), torch.float32),
                         ((1, 2, 8, 16), torch.float32),
                         ((1, 2, 8, 16), torch.float32))
    calls = []
    monkeypatch.setattr(ops, "flash_attention_ref",
                        lambda *a, **kw: calls.append(1))

    def no_library(name):
        raise RuntimeError(f"cannot build {name}: no nvcc")
    monkeypatch.setattr(_build, "load", no_library)
    with pytest.raises(RuntimeError, match="cannot build"):
        ops.flash_attention(q, k, v)
    assert not calls
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_fwd_cuda(*_fake_cuda(
            ((1, 4, 8, 24), torch.float32), ((1, 2, 8, 24), torch.float32),
            ((1, 2, 8, 24), torch.float32)))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(torch.empty(1, 2, 4, 16, device="meta"),
                            torch.empty(1, 2, 4, 16, device="meta"),
                            torch.empty(1, 2, 4, 16, device="meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_wrappers_take_exactly_the_compiled_head_dims(monkeypatch,
                                                                dtype):
    """K1 and K2 accept stablelm-3b's head dim 80 (MHA: 32 q and 32 kv
    heads) and every other compiled one, reaching the build, and still
    reject head dims no kernel is compiled for (72, 96) before it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels run instead")

    def no_library(name):
        raise RuntimeError(f"cannot build {name}: no nvcc")
    monkeypatch.setattr(_build, "load", no_library)
    assert 80 in fa_ops.HEAD_DIMS and 80 in pa_ops.HEAD_DIMS
    for hd in (*pa_ops.HEAD_DIMS, 72, 96):
        ok = hd in pa_ops.HEAD_DIMS
        q, kp, vp, table, lens = _fake_cuda(
            ((2, 32, hd), dtype), ((32, 5, 16, hd), dtype),
            ((32, 5, 16, hd), dtype), ((2, 3), torch.int32),
            ((2,), torch.int32))
        with pytest.raises(RuntimeError if ok else ValueError,
                           match="cannot build" if ok else "head dim"):
            pa_ops.paged_attention_cuda(q, kp, vp, table, lens)
        q, k, v = _fake_cuda(((1, 32, 8, hd), dtype), ((1, 32, 24, hd), dtype),
                             ((1, 32, 24, hd), dtype))
        ok = hd in fa_ops.HEAD_DIMS
        with pytest.raises(RuntimeError if ok else ValueError,
                           match="cannot build" if ok else "head dim"):
            fa_ops.flash_attention_fwd_cuda(q, k, v)
    assert pa_ops.kernel_choice(torch.bfloat16, 1, 80) == ("mma", 80)
    assert pa_ops.kernel_choice(torch.float32, 1, 80) == ("fma", 1)


def test_scan_wrappers_with_cuda_tensors_never_fall_back(monkeypatch):
    """The SSD and RG-LRU wrappers, handed CUDA tensors, build and launch
    their kernels or raise: neither reaches its plain version."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels run instead")
    calls = []
    monkeypatch.setattr(rg_ops, "rglru_scan_ref",
                        lambda *a, **k: calls.append("rg"))
    monkeypatch.setattr(ssd_ops, "_ssd_chunked",
                        lambda *a, **k: calls.append("ssd"))

    def no_library(name):
        raise RuntimeError(f"cannot build {name}: no nvcc")
    monkeypatch.setattr(_build, "load", no_library)
    a, b = _fake_cuda(((2, 40, 128), torch.float32),
                      ((2, 40, 128), torch.float32))
    before = rg_ops.launches
    with pytest.raises(RuntimeError, match="cannot build rglru_scan"):
        rg_ops.rglru_scan(a, b)
    x, dt, A, B, C = _fake_cuda(((1, 16, 2, 16), torch.float32),
                                ((1, 16, 2), torch.float32),
                                ((2,), torch.float32),
                                ((1, 16, 8), torch.float32),
                                ((1, 16, 8), torch.float32))
    with pytest.raises(RuntimeError, match="cannot build ssd"):
        ssd_ops.ssd(x, dt, A, B, C, 8)
    assert not calls and rg_ops.launches == before
    # the wrappers' own checks run before any build or launch
    with pytest.raises(ValueError, match="must be on"):
        rg_ops.rglru_scan_cuda(torch.zeros(2, 40, 128), b)
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_cuda(*_fake_cuda(((1, 16, 2, 16), torch.bfloat16)),
                         dt, A, B, C, 8)
    with pytest.raises(ValueError, match="at most 256"):
        ssd_ops.ssd_cuda(*_fake_cuda(((1, 512, 2, 16), torch.float32),
                                     ((1, 512, 2), torch.float32)), A,
                         *_fake_cuda(((1, 512, 8), torch.float32),
                                     ((1, 512, 8), torch.float32)), 512)
    with pytest.raises(ValueError, match="no kernel for device"):
        rg_ops.rglru_scan(torch.empty(1, 4, 8, device="meta"),
                          torch.empty(1, 4, 8, device="meta"))


def test_matmul_wrapper_with_cuda_tensors_never_falls_back(monkeypatch):
    """K3's wrapper, handed CUDA tensors, builds and launches its kernel or
    raises: it never reaches the plain version (nor torch.matmul)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul import ops
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs instead")
    calls = []
    monkeypatch.setattr(ops, "matmul_ref", lambda *a, **k: calls.append(1))

    def no_library(name):
        raise RuntimeError(f"cannot build {name}: no nvcc")
    monkeypatch.setattr(_build, "load", no_library)
    # resolving the platform of a CUDA tensor reads its capability
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    a, b = _fake_cuda(((64, 32), torch.float32), ((32, 48), torch.float32))
    before = ops.launches
    with pytest.raises(RuntimeError, match="cannot build matmul"):
        ops.matmul(a, b)
    with pytest.raises(RuntimeError, match="cannot build matmul"):
        ops.matmul(a, b, platform="h100")
    assert not calls and ops.launches == before
    # the wrapper's own checks run before any build or launch
    with pytest.raises(ValueError, match="must be on"):
        ops.matmul_cuda(torch.zeros(64, 32), b)
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        ops.matmul_cuda(a, a)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.matmul(a, b)


def test_recurrent_archs_need_cuda_unless_cpu_is_asked(tmp_path):
    """Runtime, Container and Pod for mamba2 and recurrentgemma: the card
    by default (raising without one), the CPU only when asked."""
    from repro_torch.core.runtime import Runtime
    from repro_torch.orchestrator import Pod
    rt = Runtime(tmp_path / "rt")
    for arch in ("mamba2-2.7b-smoke", "recurrentgemma-2b-smoke"):
        rt.build(IMAGEFILE.replace("llama3.2-3b-smoke", arch), tag=arch)
        if torch.cuda.is_available():
            assert rt.run(arch).device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rt.run(arch)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Pod(rt, arch, replicas=1, n_slots=1, max_len=16)
        pod = Pod(rt, arch, replicas=1, n_slots=1, max_len=16,
                  platform="cpu")
        assert pod.engines[0].container.device == torch.device("cpu")


def test_build_needs_nvcc_and_writes_under_build(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
    assert set(_build.SOURCES) == {"paged_attention", "flash_attention_fwd",
                                   "flash_attention_bwd", "ssd",
                                   "rglru_scan", "matmul"}
    for src in _build.SOURCES.values():
        text = (_build.CSRC / src).read_text()
        assert "Replaces: src/repro/kernels/" in text
        assert 'extern "C"' in text and "cudaGetLastError" in text
    p1 = _build.library_path("paged_attention")
    assert p1.parent == _build.BUILD_DIR and p1.suffix == ".so"
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc_path()


def test_attend_on_cuda_raises_outside_the_flash_kernels_layout():
    """On a card, ``attend`` with Sq > 1 and float32 scores runs the flash
    kernel, over the canonical causal layout only: anything else raises
    before a launch, never computes another function."""
    from repro_torch.models.attention import attend
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs instead")
    q, k, v = _fake_cuda(((2, 8, 4, 16), torch.float32),
                         ((2, 8, 2, 16), torch.float32),
                         ((2, 8, 2, 16), torch.float32))
    pos = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="canonical causal layout"):
        attend(q, k, v, pos.expand(2, 8), pos.expand(2, 8))
    with pytest.raises(ValueError, match="canonical causal layout"):
        attend(q, k, v, pos, pos, q_offset=3)


# bfloat16 scores: float32 inputs agree to float32 rounding (the score
# chain rounds to bfloat16 at the same points in both packages);
# bfloat16 inputs within one bfloat16 rounding of outputs up to 4
ATTEND_BF16_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 24, 24, 4, 2, 16, 0, 0),
                                  (1, 40, 40, 4, 1, 32, 0, 16),
                                  (2, 8, 20, 4, 2, 16, 12, 0)],
                         ids=["prefill", "window", "suffix"])
def test_attend_bf16_scores_match_jax(dtype, case):
    """``score_dtype=bfloat16`` is the reference's low-precision score
    chain (``repro.models.attention._sdpa_chunked``, XLA, no Pallas
    kernel); the port computes it with its own ``_sdpa_chunked``, on the
    CPU here and on the card alike (chosen by dtype before any launch).
    Held against the JAX ``attend`` with chunks of 16."""
    import jax.numpy as jnp
    import numpy as np

    from repro.models.attention import attend as j_attend
    from repro_torch.models.attention import attend
    B, Sq, Sk, Hq, Hkv, hd, off, window = case
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    qp = (off + np.arange(Sq, dtype=np.int32))[None]
    kp = np.arange(Sk, dtype=np.int32)[None]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jo = j_attend(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(qp),
                  jnp.asarray(kp), window, score_dtype=jnp.bfloat16,
                  q_chunk=16, kv_chunk=16, q_offset=off)
    to = attend(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                torch.from_numpy(qp), torch.from_numpy(kp), window,
                score_dtype=torch.bfloat16, q_chunk=16, kv_chunk=16,
                q_offset=off)
    assert to.dtype == dtype
    err = float(np.abs(np.asarray(jo, np.float32) - to.float().numpy()).max())
    assert err <= ATTEND_BF16_TOL[dtype], err
