#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Every phase runs, in order; any failure -> exit 1, no result line:

  device    the card's name and power limit (nvidia-smi); TF32 off for
            matmuls and cuDNN, so float32 comparisons are float32
  build     nvcc builds every kernel from src/repro_torch/csrc
  kernels   each kernel against its plain PyTorch version on the card, at
            the shapes the serving path gives it, with times (CUDA events,
            median, L2 flushed before each sample), the least time the card
            could take (bound) and the plain version's and a library call's
            times
  parity    llama3.2-3b-smoke in float32, one 12-request paged trace with
            the prefix cache on, served on the card and on the CPU with the
            same weights: per-request tokens must be identical
  serve     the slice at full width: llama3.2-3b (28 layers, d_model 3072,
            bfloat16, random seeded weights) behind Runtime -> Pod ->
            ContinuousScheduler, paged with the prefix cache on, 16
            requests x 32 new tokens; kernel launch counts must match the
            dispatches the scheduler ran

The kernel counters are set to 0 just before the serve phase drives the
pod and read just after. Output ends with a JSON line of kernel records,
the card line, and ``{"ok": true, "device": {...}}``. Without CUDA, or
without the port beside this file, it exits non-zero and prints no result.
``chip_profile.py`` breaks the served pod's time down by operator.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("device", "build", "kernels", "parity", "serve")

# published peaks of one H100 SXM (NVIDIA data sheet, dense): memory rate,
# and operations per second by input type (float32 outside tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 3e-2}

KERNELS = {
    "paged_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:96",
    },
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
    },
}

SMOKE_IMAGEFILE = """\
FROM scratch
ARCH llama3.2-3b-smoke
MESH local
PRECISION compute=float32 params=float32
"""

FULL_IMAGEFILE = """\
FROM scratch
ARCH llama3.2-3b
MESH local
PRECISION compute=bfloat16 params=bfloat16
"""


class PhaseError(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of ``fn`` over ``samples`` single calls, each
    started with a cold L2 (a 256 MiB buffer is rewritten before it). A
    device-side spin of about 10 ms follows the flush, so the host has
    queued all of ``fn``'s launches before the start event fires: the
    interval holds device time, not the host's launch overhead."""

    SPIN_CYCLES = 20_000_000

    def __init__(self, torch, samples: int = 15, warmup: int = 3):
        self.torch = torch
        self.samples, self.warmup = samples, warmup
        self.flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.samples):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch, state) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    state["card"] = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} (count "
        f"{torch.cuda.device_count()}); nvidia-smi: {state['card']}")
    log("device: TF32 disabled for matmul and cuDNN "
        "(float32 comparisons run in float32)")


def phase_build(torch, state) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    res = _build.build()
    for name, r in res.items():
        log(f"build: {name} {r['seconds']:.1f} s")
    log(f"build: all kernels in {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR})")


def _paged_case(torch, rng, *, B, n_kv, g, hd, ps, lengths, dtype, poison):
    """A shuffled paged layout: live pages scattered over the pool, the
    garbage page 0, spare pages and the tail of each last page poisoned."""
    import numpy as np
    mp = max(-(-int(l) // ps) for l in lengths) + 1
    n_alloc = sum(-(-int(l) // ps) for l in lengths)
    n_pages = n_alloc + 4
    free = list(range(1, n_pages))
    rng.shuffle(free)
    table = np.zeros((B, mp), np.int32)
    live = np.zeros((n_pages, ps), bool)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // ps)):
            p = free.pop()
            table[b, j] = p
            n = min(ps, int(lengths[b]) - j * ps)
            live[p, :n] = True
    q = rng.standard_normal((B, n_kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((n_kv, n_pages, ps, hd)).astype(np.float32)
    v = rng.standard_normal((n_kv, n_pages, ps, hd)).astype(np.float32)
    if poison:
        k[:, ~live] = 1e9
        v[:, ~live] = 1e9
    dev = "cuda"
    t = lambda a: torch.from_numpy(a).to(dev, dtype)       # noqa: E731
    return (t(q), t(k), t(v), torch.from_numpy(table).to(dev),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev))


# K1 at llama3.2-3b's decode shape: 8 slots, ragged lengths 1..2048
K1_SHAPE = dict(B=8, n_kv=8, g=3, hd=128, ps=16)


def k1_case(torch, dtype):
    """K1's inputs at K1_SHAPE (from fixed seeds) and their lengths."""
    import numpy as np
    B = K1_SHAPE["B"]
    rng = np.random.default_rng(0)
    lengths = np.concatenate([[1, 2048],
                              rng.integers(2, 2048, B - 2)]).astype(np.int32)
    args = _paged_case(torch, np.random.default_rng(1), lengths=lengths,
                       dtype=dtype, poison=True, **K1_SHAPE)
    return args, lengths


def phase_kernels(torch, state, timer) -> None:
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    records = state["records"]
    failures = []
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # -- K1: llama3.2-3b decode shapes ------------------------------------
    B, n_kv, g, hd, ps = (K1_SHAPE[k] for k in ("B", "n_kv", "g", "hd", "ps"))
    for window in (0, 200):
        for dname, dt in dts.items():
            args, lengths = k1_case(torch, dt)
            out = pa_ops.paged_attention_cuda(*args, window=window)
            ref = paged_attention_ref(*args, window=window)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            finite = bool(torch.isfinite(out).all())
            ok = finite and err <= TOL[dname]
            log(f"kernels: paged_attention B={B} n_kv={n_kv} g={g} hd={hd} "
                f"ps={ps} lengths 1..2048 window={window} {dname}: "
                f"max_abs_err {err:.3e} (tol {TOL[dname]:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"paged_attention {dname} window={window}")
            if window == 0 and dname == "bfloat16":
                ms = timer(lambda: pa_ops.paged_attention_cuda(*args))
                plain = timer(lambda: paged_attention_ref(*args))
                pages = sum(-(-int(l) // ps) for l in lengths)
                isz = out.element_size()
                nbytes = (2 * pages * n_kv * ps * hd * isz       # live K+V
                          + 2 * B * n_kv * g * hd * isz          # q, out
                          + args[3].numel() * 4 + B * 4)         # table, lens
                flops = 4.0 * B * n_kv * g * hd * float(lengths.sum())
                bms, by = bound_ms(nbytes, flops, dname)
                records["paged_attention"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)
                log(f"kernels: paged_attention bf16 time {ms:.4f} ms, plain "
                    f"{plain:.4f} ms, bound {bms:.4f} ms ({by}: "
                    f"{nbytes / 1e6:.2f} MB live), library none "
                    f"[{state['card']}]")

    # -- K2: prefill and suffix-prefill shapes --------------------------------
    Hq, Hkv, d = 24, 8, 128
    for (Sq, Sk) in ((512, 512), (128, 328)):
        for dname, dt in dts.items():
            r = np.random.default_rng(2)
            q = torch.from_numpy(r.standard_normal((1, Hq, Sq, d)).astype(
                np.float32)).to("cuda", dt)
            k = torch.from_numpy(r.standard_normal((1, Hkv, Sk, d)).astype(
                np.float32)).to("cuda", dt)
            v = torch.from_numpy(r.standard_normal((1, Hkv, Sk, d)).astype(
                np.float32)).to("cuda", dt)
            out = fa_ops.flash_attention_fwd_cuda(q, k, v, causal=True)
            ref = flash_attention_ref(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            finite = bool(torch.isfinite(out).all())
            ok = finite and err <= TOL[dname]
            log(f"kernels: flash_attention_fwd B=1 Hq={Hq} Hkv={Hkv} d={d} "
                f"Sq={Sq} Sk={Sk} causal {dname}: max_abs_err {err:.3e} "
                f"(tol {TOL[dname]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash_attention_fwd {dname} Sq={Sq} Sk={Sk}")
            if Sq == Sk and dname == "bfloat16":
                ms = timer(lambda: fa_ops.flash_attention_fwd_cuda(
                    q, k, v, causal=True))
                plain = timer(lambda: flash_attention_ref(q, k, v,
                                                          causal=True))
                lib = timer(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
                isz = out.element_size()
                nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz
                pairs = sum(min(Sk, i + (Sk - Sq) + 1) for i in range(Sq))
                flops = 4.0 * Hq * pairs * d
                bms, by = bound_ms(nbytes, flops, dname)
                records["flash_attention_fwd"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib)
                log(f"kernels: flash_attention_fwd bf16 time {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), "
                    f"library (scaled_dot_product_attention) {lib:.4f} ms "
                    f"[{state['card']}]")
    check(not failures, "kernel mismatches: " + "; ".join(failures))


def _launch_counts():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    return {"paged_attention": pa_ops.launches,
            "flash_attention_fwd": fa_ops.launches}


def _reset_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    pa_ops.launches = 0
    fa_ops.launches = 0


def _serve(Pod, ContinuousScheduler, rt, reqs, **kw):
    pod = Pod(rt, "stable", replicas=1, **kw)
    sched = ContinuousScheduler(pod)
    sched.submit(reqs)
    sched.run(max_ticks=10_000)
    return pod, sched


def phase_parity(torch, state, workdir: Path) -> None:
    import numpy as np
    from repro_torch.core.runtime import Runtime
    from repro_torch.orchestrator import (ContinuousScheduler, GenRequest,
                                          Pod)

    rt = Runtime(workdir / "smoke")
    rt.build(SMOKE_IMAGEFILE, tag="stable")
    params = rt.run("stable", platform="cpu").init_params(0)

    def trace():
        rng = np.random.default_rng(7)
        shared = rng.integers(0, 256, 20)
        out = []
        for i in range(12):
            tail = rng.integers(0, 256, int(rng.integers(3, 24)))
            share = i in (2, 7)
            out.append(GenRequest(
                rid=i, prompt=np.concatenate([shared, tail]) if share else tail,
                max_new_tokens=int(rng.integers(3, 10)),
                prefix_len=20 if share else 0))
        return out

    kw = dict(n_slots=4, max_len=64, paged=True, page_size=8,
              prefix_cache=True, params=params)
    tokens = {}
    for platform in ("cuda", "cpu"):
        reqs = trace()
        before = _launch_counts()
        pod, _ = _serve(Pod, ContinuousScheduler, rt, reqs,
                        platform=None if platform == "cuda" else "cpu", **kw)
        after = _launch_counts()
        check(all(r.state == "done" for r in reqs),
              f"parity: {platform} run left requests unfinished")
        tokens[platform] = [list(r.tokens) for r in reqs]
        used = {k: after[k] - before[k] for k in after}
        eng = pod.engines[0]
        log(f"parity: {platform} run, {len(reqs)} requests, prefix hits "
            f"{eng.prefix_hits}, kernel launches {used}")
        if platform == "cuda":
            check(all(used.values()),
                  f"parity: card run skipped a kernel: {used}")
            check(eng.prefix_hits >= 1, "parity: no prefix hit on the card")
        else:
            check(not any(used.values()),
                  f"parity: CPU run launched kernels: {used}")
    same = tokens["cuda"] == tokens["cpu"]
    log(f"parity: tokens card vs CPU identical: {same}")
    check(same, f"parity: tokens differ\n card {tokens['cuda']}\n "
                f"cpu  {tokens['cpu']}")


def phase_serve(torch, state, workdir: Path) -> None:
    import numpy as np
    from repro_torch.core.runtime import Runtime
    from repro_torch.orchestrator import (ContinuousScheduler, GenRequest,
                                          Pod)

    rt = Runtime(workdir / "full")
    rt.build(FULL_IMAGEFILE, tag="stable")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pod = Pod(rt, "stable", replicas=1, n_slots=8, max_len=1024, paged=True,
              page_size=16, prefix_cache=True, decode_chunk=4, seed=0)
    torch.cuda.synchronize()
    log(f"serve: pod up (params from seed 0, pool "
        f"{pod.engines[0].n_pages} pages) in {time.perf_counter() - t0:.1f} s")
    cfg = pod.engines[0].container.arch
    n_layers = cfg.n_layers

    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, 256)
    reqs = []
    for i in range(8):
        reqs.append(GenRequest(
            rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                       int(rng.integers(64, 513))),
            max_new_tokens=32))
    for i in range(8, 16):
        tail = rng.integers(0, cfg.vocab_size, int(rng.integers(300, 513)) - 256)
        reqs.append(GenRequest(rid=i, prompt=np.concatenate([shared, tail]),
                               max_new_tokens=32, prefix_len=256))

    sched = ContinuousScheduler(pod)
    sched.submit(reqs)
    _reset_counts()
    t0 = time.perf_counter()
    sched.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    state["launches"] = counts

    eng = pod.engines[0]
    done = [r for r in reqs if r.state == "done"]
    ntok = [len(r.tokens) for r in reqs]
    decode_steps = eng.decode_ticks
    prefill_disp = eng._c_prefill_disp.value
    log(f"serve: {len(done)}/16 done in {wall:.2f} s, tokens per request "
        f"{sorted(set(ntok))}, prefix hits {eng.prefix_hits}, prefill "
        f"dispatches {prefill_disp}, decode steps {decode_steps} "
        f"({eng._c_decode_disp.value} dispatches)")
    log(f"serve: launches {counts}; expected paged_attention "
        f"{n_layers} x {decode_steps} = {n_layers * decode_steps}, "
        f"flash_attention_fwd {n_layers} x {prefill_disp} = "
        f"{n_layers * prefill_disp}")
    check(len(done) == 16 and all(n == 32 for n in ntok),
          f"serve: not all requests completed with 32 tokens: {ntok}")
    check(counts["paged_attention"] == n_layers * decode_steps,
          "serve: paged_attention launches do not match decode steps")
    check(counts["flash_attention_fwd"] == n_layers * prefill_disp,
          "serve: flash_attention_fwd launches do not match prefills")
    check(eng.prefix_hits >= 1, "serve: the shared prefix never hit")

    prefill_pos = eng.prefill_positions
    decode_tokens = eng.tokens_generated - prefill_disp
    peak = torch.cuda.max_memory_allocated()
    log(f"serve: prefill {prefill_pos} positions in {eng.prefill_s:.3f} s = "
        f"{prefill_pos / eng.prefill_s:.1f} tokens/s; decode {decode_tokens} "
        f"tokens in {eng.decode_s:.3f} s = "
        f"{decode_tokens / eng.decode_s:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB [{state['card']}]")

    # logits of the served model: finite, of the expected shape
    c = eng.container
    prompt = torch.as_tensor(reqs[15].prompt[None], device=c.device)
    with torch.no_grad():
        logits, _ = c.model.forward(eng.params, prompt)
    torch.cuda.synchronize()
    from repro_torch.models.layers import padded_vocab
    shape_ok = tuple(logits.shape) == (1, prompt.shape[1],
                                       padded_vocab(cfg.vocab_size))
    finite = bool(torch.isfinite(logits).all())
    log(f"serve: full-width logits {tuple(logits.shape)} finite={finite}")
    check(shape_ok and finite, "serve: logits NaN/inf or misshapen")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no port at {SRC / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    state = {"records": {}, "launches": {}, "card": ""}
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        timer = None
        for phase in PHASES:
            t0 = time.perf_counter()
            log(f"== {phase}")
            try:
                if phase == "device":
                    phase_device(torch, state)
                elif phase == "build":
                    phase_build(torch, state)
                elif phase == "kernels":
                    timer = timer or Timer(torch)
                    phase_kernels(torch, state, timer)
                elif phase == "parity":
                    phase_parity(torch, state, workdir)
                elif phase == "serve":
                    phase_serve(torch, state, workdir)
            except Exception as e:          # report every phase, then fail
                failed.append(phase)
                log(f"FAIL {phase}: {type(e).__name__}: {e}")
                if not isinstance(e, PhaseError):
                    import traceback
                    traceback.print_exc(file=sys.stdout)
            log(f"== {phase} {'failed' if phase in failed else 'passed'} "
                f"in {time.perf_counter() - t0:.1f} s")

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "repro" or m.startswith("repro."))
    if leaked:
        failed.append("imports")
        log(f"FAIL imports: the port pulled in {leaked[:5]}")
    unmeasured = [n for n in KERNELS if n not in state["records"]
                  or not state["launches"].get(n)]
    if unmeasured:
        failed.append("records")
        log(f"FAIL records: no measurement or no launch for {unmeasured}")
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1

    kernels = []
    for name, meta in KERNELS.items():
        kernels.append({"name": name, **meta,
                        "launches": state["launches"][name],
                        **state["records"][name]})
    print(json.dumps({"kernels": kernels}))
    print(state["card"] or "card: not queried")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
