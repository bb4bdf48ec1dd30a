"""Import and device hygiene of the PyTorch port.

* every ``repro_torch`` module imports without jax, without the JAX package
  ``repro`` and without triton (a host without triton or nvcc must import it);
* no source line of the port, ``chip_smoke.py`` or ``chip_profile.py``
  imports jax or repro;
* the default platform is the card: without CUDA, ``Runtime.run`` raises
  unless the caller asks for ``platform="cpu"``;
* a kernel wrapper handed non-CPU tensors launches its kernel or raises --
  it never falls back to the plain version.
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


def test_build_needs_nvcc_and_writes_under_build(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
    assert set(_build.SOURCES) == {"paged_attention", "flash_attention_fwd"}
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
    """On a card, ``attend`` with Sq > 1 runs the flash kernel, which scores
    in float32 over the canonical causal layout only: anything else raises
    before a launch, never computes another function."""
    from repro_torch.models.attention import attend
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs instead")
    q, k, v = _fake_cuda(((2, 8, 4, 16), torch.float32),
                         ((2, 8, 2, 16), torch.float32),
                         ((2, 8, 2, 16), torch.float32))
    pos = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(NotImplementedError, match="float32 only"):
        attend(q, k, v, pos, pos, score_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="canonical causal layout"):
        attend(q, k, v, pos.expand(2, 8), pos.expand(2, 8))
    with pytest.raises(ValueError, match="canonical causal layout"):
        attend(q, k, v, pos, pos, q_offset=3)
