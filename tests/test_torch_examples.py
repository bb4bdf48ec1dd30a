"""The port's four examples (``repro_torch.examples``) against the JAX
package's (``examples/``), on the CPU (``--platform cpu``).

Both sides train and serve the same model: the port's
``Container.init_params`` loads the JAX package's ``init_params(seed)``
for the same arch (``tests/torch_ref.py::jax_init``; torch's RNG cannot
replay the JAX init). Each JAX example runs as written, from its file, with
its temporary root moved under the test's ``tmp_path``; its per-step losses
are read at full precision by wrapping the ``jax.jit`` it calls
(quickstart, hpc_migration) or from the overlay's ``metrics.jsonl``
(train_100m), its serve result by wrapping ``serve_main``.

* quickstart: the same image digest, layer history and tags, and the 15
  per-step losses (10, a checkpoint, 5 resumed in a fresh container)
  within ``STEP_TOL``, the bound ``tests/test_torch_train.py`` holds
  multi-step float32 training to;
* hpc_migration: the same two image digests, ABIs and push (2 new layers,
  8 reused), and the 10 per-step losses within ``STEP_TOL``: 5 laptop
  steps under ``generic``, then 5 after the reshard restore under
  ``host`` with ZeRO-1 and its bfloat16 gradient wire. On one rank the
  wire rounds the same float32 gradients on both sides, so the bound
  holds (across 4 ranks gloo's rounding order differs: ROADMAP Queue 3
  item 15);
* serve_batched: both examples as written (8 requests, 64-token prompts,
  up to 32 new tokens), the same tokens for every request;
* train_100m: 2 steps of each (``--steps 2``) at the example's own
  width (0.10 B params), both losses within ``BF16_TOL``: the image
  computes in bfloat16, so activations round to 8 mantissa bits on both
  sides, in each package's own order (1e-3 of a loss near 10.4 is 1e-4
  relative).
"""

import contextlib
import importlib.util
import io
import itertools
import json
import sys
import tempfile
import types
import uuid
from pathlib import Path

import jax
import pytest

import torch_ref
from repro_torch.core.container import Container
from repro_torch.examples import (hpc_migration, quickstart, serve_batched,
                                  train_100m)

pytestmark = pytest.mark.orchestrator

REPO = Path(__file__).resolve().parent.parent

STEP_TOL = 1e-4
BF16_TOL = 1e-3


def _jax_example(name: str):
    """``examples/<name>.py`` of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_weights(monkeypatch):
    monkeypatch.setattr(Container, "init_params",
                        lambda self, seed=0: self.load_params(
                            torch_ref.jax_init(self, seed)))


@pytest.fixture
def same_ids(monkeypatch):
    """``restart()`` makes the next ``uuid.uuid4`` calls return the same
    sequence again."""
    counter = [itertools.count(1)]
    monkeypatch.setattr(
        uuid, "uuid4", lambda: uuid.UUID(int=next(counter[0]) << 96))

    def restart():
        counter[0] = itertools.count(1)
    return restart


def _jax_root(monkeypatch, path: Path):
    path.mkdir(parents=True)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": str(path))


def _recording_jit(mod, monkeypatch) -> list:
    """Every call of a step the example jits appends its float loss."""
    losses = []

    def jit(fn, **kw):
        step = jax.jit(fn, **kw)

        def call(*a):
            out = step(*a)
            losses.append(float(out[2]["loss"]))
            return out
        return call
    monkeypatch.setattr(mod, "jax", types.SimpleNamespace(jit=jit))
    return losses


def _run(fn, *a) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a)
    return res, out.getvalue()


def _close(jl, tl, tol, what):
    assert len(jl) == len(tl), (what, len(jl), len(tl))
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert abs(a - b) <= tol, (what, i + 1, a, b)


def test_quickstart_matches_jax(tmp_path, monkeypatch, jax_weights):
    jex = _jax_example("quickstart")
    jlosses = _recording_jit(jex, monkeypatch)
    _jax_root(monkeypatch, tmp_path / "jax")
    _, jout = _run(jex.main)
    res, tout = _run(quickstart.main, ["--platform", "cpu", "--root",
                                       str(tmp_path / "torch")])
    _close(jlosses, res["losses"], STEP_TOL, "quickstart")
    assert len(res["losses"]) == 15 and res["losses"][-1] < res["losses"][0]

    def build_lines(out):
        head = out.split("== docker run stable ==")[0]
        return [ln for ln in head.splitlines() if ln.strip()]
    assert build_lines(tout) == build_lines(jout)
    assert res["image"][:12] in tout
    # the printed steps are the returned losses
    for i, loss in enumerate(res["losses"]):
        assert f"step {i + 1:2d}  loss {loss:.4f}" in tout
    ps = [out.split("containers run from this image: ")[1].splitlines()[0]
          for out in (tout, jout)]
    assert [p.count(f"'{res['image'][:12]}-") for p in ps] == [2, 2]


def test_hpc_migration_matches_jax(tmp_path, monkeypatch, jax_weights):
    jex = _jax_example("hpc_migration")
    jlosses = _recording_jit(jex, monkeypatch)
    _jax_root(monkeypatch, tmp_path / "jax")
    _, jout = _run(jex.main)
    res, tout = _run(hpc_migration.main, ["--platform", "cpu", "--root",
                                          str(tmp_path / "torch")])
    _close(jlosses, res["losses"], STEP_TOL, "hpc_migration")
    assert len(res["losses"]) == 10 and res["losses"][-1] < res["losses"][0]
    assert (res["layers_transferred"], res["layers_reused"]) == (2, 8)

    def line(out, start):
        return next(ln for ln in out.splitlines() if ln.startswith(start))
    push = "[registry] pushed hpc image: 2 new layers, 8 reused (dedupe 80%)"
    assert line(tout, "[registry]") == line(jout, "[registry]")
    assert line(tout, "[registry]").startswith(push)
    for start, digest in (("[laptop] running", res["images"][0]),
                          ("[hpc] running", res["images"][1])):
        assert line(tout, start).split()[2] == \
            line(jout, start).split()[2] == digest[:12]
    assert "(abi=host+zero1" in line(tout, "[hpc] running")
    assert line(tout, "[hpc] running").split("(abi=")[1] == \
        line(jout, "[hpc] running").split("(abi=")[1]


def test_serve_batched_matches_jax(tmp_path, monkeypatch, jax_weights,
                                   same_ids):
    jex = _jax_example("serve_batched")
    outs = []

    def serve_main(argv):
        outs.append(jex_serve(argv))
        return outs[-1]
    jex_serve = jex.serve_main
    monkeypatch.setattr(jex, "serve_main", serve_main)
    _jax_root(monkeypatch, tmp_path / "jax")
    same_ids()
    _run(jex.main)
    same_ids()
    tres, _ = _run(serve_batched.main, ["--platform", "cpu", "--root",
                                        str(tmp_path / "torch")])
    jres = outs[0]
    assert tres["requests"] == jres["requests"] == 8
    assert tres["request_tokens"] == jres["request_tokens"]
    for k in ("tokens", "decode_ticks", "prefill_positions",
              "p50_latency_ticks", "p99_latency_ticks"):
        assert tres[k] == jres[k], k
    assert max(len(t) for t in tres["request_tokens"].values()) == 32


def _metrics_losses(overlay: str) -> list:
    lines = (Path(overlay) / "metrics.jsonl").read_text().splitlines()
    return [json.loads(ln)["loss"] for ln in lines]


def test_train_100m_two_steps_match_jax(tmp_path, monkeypatch, jax_weights):
    jex = _jax_example("train_100m")
    outs = []

    def train_main(argv):
        outs.append(jex_train(argv))
        return outs[-1]
    jex_train = jex.train_main
    monkeypatch.setattr(jex, "train_main", train_main)
    monkeypatch.setattr(sys, "argv", ["train_100m.py", "--steps", "2"])
    _jax_root(monkeypatch, tmp_path / "jax")
    _run(jex.main)
    tres, tout = _run(train_100m.main, ["--steps", "2", "--platform", "cpu",
                                        "--root", str(tmp_path / "torch")])
    jl = _metrics_losses(outs[0]["overlay"])
    tl = [tres["losses"][s] for s in sorted(tres["losses"])]
    assert tl == _metrics_losses(tres["overlay"])
    _close(jl, tl, BF16_TOL, "train_100m")
    assert f"final loss after 2 steps: {tl[-1]:.4f}" in tout
