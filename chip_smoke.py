#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Every phase runs, in order; any failure -> exit 1, no result line:

  device    the card's name and power limit (nvidia-smi); TF32 off for
            matmuls and cuDNN, so float32 comparisons are float32
  build     nvcc builds every kernel from src/repro_torch/csrc
  kernels   each kernel against its plain PyTorch version on the card, at
            the shapes the serving paths give it, with times (CUDA events,
            median, L2 flushed before each sample), the least time the card
            could take (bound) and the plain version's and a library call's
            times
  parity    the smoke reductions in float32, served on the card and on the
            CPU with the same weights, per-request tokens identical:
            llama3.2-3b-smoke (12-request paged trace, prefix cache on),
            mamba2-2.7b-smoke and recurrentgemma-2b-smoke (contiguous
            slots; recurrentgemma's prompts pass its 16-token window)
  serve     three full-width pods, bfloat16, random weights from seed 0,
            behind Runtime -> Pod -> ContinuousScheduler, 32 new tokens a
            request, no EOS:
              llama3.2-3b (28 layers), paged, prefix cache on, 16 requests;
              mamba2-2.7b (64 ssm layers), contiguous, 12 requests of
                64-768 prompt tokens;
              recurrentgemma-2b (18 rec + 8 local-attention layers),
                contiguous, max_len 4096, 8 requests, 2 of them 2304-token
                prompts past the 2048 window;
            each pod's kernel launch counts must match the dispatches its
            scheduler ran

The kernel counters are set to 0 just before each pod of the serve phase
is driven and read just after. Output ends with a JSON line of kernel
records, the card line, and ``{"ok": true, "device": {...}}``. Without
CUDA, or without the port beside this file, it exits non-zero and prints no
result. ``chip_profile.py`` breaks the llama pod's time down by operator.
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
    "ssd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:89",
    },
    "rglru_scan": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:48",
    },
}

# the scans run in float32 only (as the models call them): K5 within 1e-4 of
# its plain chunked version relative to the output's max (the JAX kernel
# suite's bound), K4 within 1e-5 of its plain sequential version, absolute,
# scaled by max(1, max |h|)
SSD_REL_TOL = 1e-4
RGLRU_TOL = 1e-5

SMOKE_IMAGEFILE = """\
FROM scratch
ARCH {arch}
MESH local
PRECISION compute=float32 params=float32
"""

FULL_IMAGEFILE = """\
FROM scratch
ARCH {arch}
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

# K2 (Hq, Hkv, d, Sq, Sk, window): llama3.2-3b's 512-token prefill (the
# kernel's record) and a suffix prefill over a 200-token prefix, then
# recurrentgemma-2b's local-attention prefill past its 2048 window
K2_CASES = ((24, 8, 128, 512, 512, 0), (24, 8, 128, 128, 328, 0),
            (10, 1, 256, 2304, 2304, 2048))


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

    # -- K2: llama3.2-3b prefill and suffix prefill; recurrentgemma-2b's
    # local-attention prefill of 2304 tokens, window 2048 (query tiles past
    # the window start their key loop late) -----------------------------
    for (Hq, Hkv, d, Sq, Sk, window) in K2_CASES:
        for dname, dt in dts.items():
            r = np.random.default_rng(2)
            q = torch.from_numpy(r.standard_normal((1, Hq, Sq, d)).astype(
                np.float32)).to("cuda", dt)
            k = torch.from_numpy(r.standard_normal((1, Hkv, Sk, d)).astype(
                np.float32)).to("cuda", dt)
            v = torch.from_numpy(r.standard_normal((1, Hkv, Sk, d)).astype(
                np.float32)).to("cuda", dt)
            out = fa_ops.flash_attention_fwd_cuda(q, k, v, causal=True,
                                                  window=window)
            ref = flash_attention_ref(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            finite = bool(torch.isfinite(out).all())
            ok = finite and err <= TOL[dname]
            log(f"kernels: flash_attention_fwd B=1 Hq={Hq} Hkv={Hkv} d={d} "
                f"Sq={Sq} Sk={Sk} causal window={window} {dname}: "
                f"max_abs_err {err:.3e} (tol {TOL[dname]:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash_attention_fwd {dname} d={d} Sq={Sq} "
                                f"Sk={Sk} window={window}")
            del ref
            if Sq != Sk or dname != "bfloat16":
                continue
            ms = timer(lambda: fa_ops.flash_attention_fwd_cuda(
                q, k, v, causal=True, window=window))
            plain = timer(lambda: flash_attention_ref(q, k, v, causal=True,
                                                      window=window))
            # SDPA with an explicit mask when windowed (it has no window
            # argument), with is_causal otherwise
            mask = None
            if window:
                rows = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
                cols = torch.arange(Sk, device="cuda")[None, :]
                mask = (cols <= rows) & (cols > rows - window)
            lib = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True))
            isz = out.element_size()
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz
            off = Sk - Sq
            pairs = sum(min(Sk, i + off + 1)
                        - (max(0, i + off - window + 1) if window else 0)
                        for i in range(Sq))
            flops = 4.0 * Hq * pairs * d
            bms, by = bound_ms(nbytes, flops, dname)
            if "flash_attention_fwd" not in records:
                records["flash_attention_fwd"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib)
            lib_txt = (f"library (scaled_dot_product_attention"
                       f"{', boolean mask' if window else ''}) {lib:.4f} ms")
            log(f"kernels: flash_attention_fwd Hq={Hq} d={d} S={Sq} "
                f"window={window} bf16 time {ms:.4f} ms, plain {plain:.4f} "
                f"ms, bound {bms:.4f} ms ({by}), {lib_txt} [{state['card']}]")

    failures += _kernels_ssd(torch, state, timer)
    failures += _kernels_rglru(torch, state, timer)
    check(not failures, "kernel mismatches: " + "; ".join(failures))


# K5 at mamba2-2.7b's prefill (a 512-token prompt: two 256-step chunks) and
# a ragged batch of two 192-token prompts (one chunk of 192 steps, not a
# multiple of the kernel's 64-row tiles)
K5_CASES = ((1, 512, 80, 64, 128, 256), (2, 192, 80, 64, 128, 192))


def ssd_flops(b: int, S: int, H: int, P: int, N: int, Q: int) -> float:
    """Operations of the chunked SSD, products at or below the diagonal
    only: head-shared C.B^T, the causal intra-chunk product, the
    inter-chunk product and the state update (2 flops a multiply-add)."""
    tri = Q * (Q + 1) // 2
    per_chunk = 2.0 * (N * tri + H * (tri * P + 2 * Q * N * P))
    return b * (S // Q) * per_chunk


def _kernels_ssd(torch, state, timer) -> list[str]:
    import numpy as np
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import _ssd_chunked

    failures = []
    for case in K5_CASES:
        b, S, H, P, N, Q = case
        rng = np.random.default_rng(3)
        t = lambda a: torch.from_numpy(                    # noqa: E731
            np.asarray(a, np.float32)).to("cuda")
        x = t(rng.standard_normal((b, S, H, P)))
        dt = t(np.log1p(np.exp(rng.standard_normal((b, S, H)) - 1.0)))
        A = t(-np.exp(0.5 * rng.standard_normal(H)))
        B = t(rng.standard_normal((b, S, N)))
        C = t(rng.standard_normal((b, S, N)))
        y, st = ssd_ops.ssd_cuda(x, dt, A, B, C, Q)
        ry, rst = _ssd_chunked(x, dt, A, B, C, Q)
        torch.cuda.synchronize()
        err_y = float((y - ry).abs().max())
        err_s = float((st - rst).abs().max())
        rel_y = err_y / float(ry.abs().max())
        rel_s = err_s / float(rst.abs().max())
        ok = (bool(torch.isfinite(y).all()) and rel_y <= SSD_REL_TOL
              and rel_s <= SSD_REL_TOL)
        log(f"kernels: ssd b={b} S={S} H={H} P={P} N={N} chunk={Q} float32: "
            f"y max_abs_err {err_y:.3e} (rel {rel_y:.2e}), final state "
            f"max_abs_err {err_s:.3e} (rel {rel_s:.2e}) (tol rel "
            f"{SSD_REL_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"ssd {case}")
        if case != K5_CASES[0]:
            continue
        ms = timer(lambda: ssd_ops.ssd_cuda(x, dt, A, B, C, Q))
        plain = timer(lambda: _ssd_chunked(x, dt, A, B, C, Q))
        nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + B.numel()
                      + C.numel() + st.numel())
        flops = ssd_flops(b, S, H, P, N, Q)
        bms, by = bound_ms(nbytes, flops, "float32")
        state["records"]["ssd"] = dict(
            max_abs_err=err_y, ms=ms, plain_ms=plain, bound_ms=bms,
            bound_by=by, library_ms=None)
        log(f"kernels: ssd float32 time {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP), library none [{state['card']}]")
    return failures


# K4 at recurrentgemma-2b's prefill widths: one 2304-token prompt, and a
# ragged batch of three 100-token prompts
K4_CASES = ((1, 2304, 2560), (3, 100, 2560))


def _kernels_rglru(torch, state, timer) -> list[str]:
    import numpy as np
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    failures = []
    for case in K4_CASES:
        rng = np.random.default_rng(4)
        a = torch.from_numpy((1.0 / (1.0 + np.exp(-rng.standard_normal(
            case)))).astype(np.float32)).to("cuda")
        b = torch.from_numpy(rng.standard_normal(case).astype(
            np.float32)).to("cuda")
        h = rg_ops.rglru_scan_cuda(a, b)
        ref = rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        err = float((h - ref).abs().max())
        tol = RGLRU_TOL * max(1.0, float(ref.abs().max()))
        ok = bool(torch.isfinite(h).all()) and err <= tol
        log(f"kernels: rglru_scan B={case[0]} S={case[1]} R={case[2]} "
            f"float32 (time chunk {rg_ops.time_chunk(*case, a.device)}): "
            f"max_abs_err "
            f"{err:.3e} against the sequential version (tol {tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"rglru_scan {case}")
        if case != K4_CASES[0]:
            continue
        ms = timer(lambda: rg_ops.rglru_scan_cuda(a, b))
        plain = timer(lambda: rglru_scan_ref(a, b))
        nbytes = 3 * a.numel() * 4
        bms, by = bound_ms(nbytes, 2.0 * a.numel(), "float32")
        state["records"]["rglru_scan"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
            bound_by=by, library_ms=None)
        log(f"kernels: rglru_scan float32 time {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bms:.4f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB), library none [{state['card']}]")
    return failures


def _ops_modules() -> dict:
    """Kernel name -> its wrapper module (each keeps ``launches``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"paged_attention": pa_ops, "flash_attention_fwd": fa_ops,
            "ssd": ssd_ops, "rglru_scan": rg_ops}


def _launch_counts() -> dict:
    return {name: m.launches for name, m in _ops_modules().items()}


def _reset_counts() -> None:
    for m in _ops_modules().values():
        m.launches = 0


def _serve(Pod, ContinuousScheduler, rt, tag, reqs, **kw):
    pod = Pod(rt, tag, replicas=1, **kw)
    sched = ContinuousScheduler(pod)
    sched.submit(reqs)
    sched.run(max_ticks=10_000)
    return pod, sched


def _parity_traces(GenRequest):
    """arch -> (trace maker, Pod keywords, kernels the card run uses)."""
    import numpy as np

    def llama():
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

    def mamba2():
        # prompts of at most one 8-step chunk, or whole chunks of it
        rng = np.random.default_rng(8)
        return [GenRequest(rid=i, prompt=rng.integers(
                    0, 256, int(rng.choice([3, 6, 8, 16, 24, 40]))),
                    max_new_tokens=int(rng.integers(3, 12)))
                for i in range(8)]

    def recurrentgemma():
        # prompts of 5-40 tokens: most pass the 16-token window, so the
        # prefill rolls the ring and decode wraps it; one of 96 gives K2 a
        # second 64-row query tile whose key loop starts past the window
        rng = np.random.default_rng(9)
        return [GenRequest(rid=i, prompt=rng.integers(
                    0, 256, 96 if i == 0 else int(rng.integers(5, 41))),
                    max_new_tokens=int(rng.integers(3, 12)))
                for i in range(8)]

    contiguous = dict(n_slots=3, max_len=64)
    return {
        "llama3.2-3b-smoke": (llama, dict(n_slots=4, max_len=64, paged=True,
                                          page_size=8, prefix_cache=True),
                              ("paged_attention", "flash_attention_fwd")),
        "mamba2-2.7b-smoke": (mamba2, contiguous, ("ssd",)),
        "recurrentgemma-2b-smoke": (recurrentgemma,
                                    dict(n_slots=3, max_len=128),
                                    ("rglru_scan", "flash_attention_fwd")),
    }


def phase_parity(torch, state, workdir: Path) -> None:
    from repro_torch.core.runtime import Runtime
    from repro_torch.orchestrator import (ContinuousScheduler, GenRequest,
                                          Pod)

    rt = Runtime(workdir / "smoke")
    failures = []
    for arch, (trace, kw, kernels) in _parity_traces(GenRequest).items():
        rt.build(SMOKE_IMAGEFILE.format(arch=arch), tag=arch)
        params = rt.run(arch, platform="cpu").init_params(0)
        tokens = {}
        for platform in ("cuda", "cpu"):
            reqs = trace()
            before = _launch_counts()
            pod, _ = _serve(Pod, ContinuousScheduler, rt, arch, reqs,
                            platform=None if platform == "cuda" else "cpu",
                            params=params, **kw)
            after = _launch_counts()
            check(all(r.state == "done" for r in reqs),
                  f"parity: {arch} {platform} run left requests unfinished")
            tokens[platform] = [list(r.tokens) for r in reqs]
            used = {k: after[k] - before[k] for k in after}
            eng = pod.engines[0]
            log(f"parity: {arch} {platform} run, {len(reqs)} requests, "
                f"prompts {sorted(len(r.prompt) for r in reqs)}, prefix hits "
                f"{eng.prefix_hits}, kernel launches {used}")
            if platform == "cuda":
                check(all(used[k] for k in kernels),
                      f"parity: {arch} card run skipped a kernel of "
                      f"{kernels}: {used}")
                if kw.get("prefix_cache"):
                    check(eng.prefix_hits >= 1,
                          f"parity: {arch}: no prefix hit on the card")
            else:
                check(not any(used.values()),
                      f"parity: {arch} CPU run launched kernels: {used}")
        same = tokens["cuda"] == tokens["cpu"]
        log(f"parity: {arch} tokens card vs CPU identical: {same}")
        if not same:
            failures.append(f"{arch}\n card {tokens['cuda']}\n "
                            f"cpu  {tokens['cpu']}")
    check(not failures, "parity: tokens differ: " + "; ".join(failures))


def _drive_pod(torch, state, rt, arch, reqs, expect, **kw):
    """Serve ``reqs`` on a fresh full-width pod of ``arch``: counters set to
    0 just before the scheduler runs and read just after. ``expect`` maps
    each kernel of the path to its launches per prefill dispatch
    ("prefill", layers) or per decode step ("decode", layers). Returns the
    pod."""
    from repro_torch.orchestrator import ContinuousScheduler, Pod

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pod = Pod(rt, arch, replicas=1, seed=0, decode_chunk=4, **kw)
    torch.cuda.synchronize()
    eng = pod.engines[0]
    log(f"serve: {arch} pod up (params from seed 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    sched = ContinuousScheduler(pod)
    sched.submit(reqs)
    _reset_counts()
    t0 = time.perf_counter()
    sched.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    for k, v in counts.items():
        state["launches"][k] = state["launches"].get(k, 0) + v

    done = [r for r in reqs if r.state == "done"]
    ntok = [len(r.tokens) for r in reqs]
    decode_steps = eng.decode_ticks
    prefill_disp = eng._c_prefill_disp.value
    log(f"serve: {arch} {len(done)}/{len(reqs)} done in {wall:.2f} s, "
        f"prompts {sorted(len(r.prompt) for r in reqs)}, tokens per request "
        f"{sorted(set(ntok))}, prefix hits {eng.prefix_hits}, prefill "
        f"dispatches {prefill_disp}, decode steps {decode_steps} "
        f"({eng._c_decode_disp.value} dispatches)")
    want = {k: layers * (prefill_disp if per == "prefill" else decode_steps)
            for k, (per, layers) in expect.items()}
    log(f"serve: {arch} launches {counts}; expected "
        + ", ".join(f"{k} {layers} x {per} = {want[k]}"
                    for k, (per, layers) in expect.items()))
    check(len(done) == len(reqs) and all(n == 32 for n in ntok),
          f"serve: {arch}: not all requests completed with 32 tokens: {ntok}")
    for k, n in want.items():
        check(counts[k] == n, f"serve: {arch}: {k} launches {counts[k]} != "
                              f"{n}")
    others = {k: v for k, v in counts.items() if k not in want and v}
    check(not others, f"serve: {arch}: launches of kernels off its path: "
                      f"{others}")
    if kw.get("prefix_cache"):
        check(eng.prefix_hits >= 1, f"serve: {arch}: the shared prefix "
                                    "never hit")

    prefill_pos = eng.prefill_positions
    decode_tokens = eng.tokens_generated - prefill_disp
    peak = torch.cuda.max_memory_allocated()
    log(f"serve: {arch} prefill {prefill_pos} positions in "
        f"{eng.prefill_s:.3f} s = {prefill_pos / eng.prefill_s:.1f} "
        f"tokens/s; decode {decode_tokens} tokens in {eng.decode_s:.3f} s = "
        f"{decode_tokens / eng.decode_s:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB [{state['card']}]")

    # logits of the served model: finite, of the expected shape
    from repro_torch.models.layers import padded_vocab
    c = eng.container
    prompt = torch.as_tensor(reqs[-1].prompt[None], device=c.device)
    with torch.no_grad():
        logits, _ = c.model.forward(eng.params, prompt)
    torch.cuda.synchronize()
    shape_ok = tuple(logits.shape) == (1, prompt.shape[1],
                                       padded_vocab(c.arch.vocab_size))
    finite = bool(torch.isfinite(logits).all())
    log(f"serve: {arch} full-width logits {tuple(logits.shape)} "
        f"finite={finite}")
    check(shape_ok and finite, f"serve: {arch} logits NaN/inf or misshapen")
    return pod


def phase_serve(torch, state, workdir: Path) -> None:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.orchestrator import GenRequest

    rt = Runtime(workdir / "full")
    failures = []

    def run(arch, build_reqs, expect, **kw):
        rt.build(FULL_IMAGEFILE.format(arch=arch), tag=arch)
        try:
            pod = _drive_pod(torch, state, rt, arch, build_reqs(arch),
                             expect, **kw)
            for e in pod.engines:
                e.release()
        except PhaseError as e:
            failures.append(str(e))
            log(f"FAIL serve: {e}")
        torch.cuda.empty_cache()

    def llama_reqs(arch):
        vocab = get_config(arch).vocab_size
        rng = np.random.default_rng(11)
        shared = rng.integers(0, vocab, 256)
        reqs = [GenRequest(rid=i, prompt=rng.integers(
                    0, vocab, int(rng.integers(64, 513))), max_new_tokens=32)
                for i in range(8)]
        for i in range(8, 16):
            tail = rng.integers(0, vocab, int(rng.integers(300, 513)) - 256)
            reqs.append(GenRequest(rid=i,
                                   prompt=np.concatenate([shared, tail]),
                                   max_new_tokens=32, prefix_len=256))
        return reqs

    def mamba2_reqs(arch):
        # a cached prefill longer than the 256-step chunk must be a multiple
        # of it (the reference's rule)
        vocab = get_config(arch).vocab_size
        rng = np.random.default_rng(12)
        lens = (64, 128, 192, 256, 512, 768) * 2
        return [GenRequest(rid=i, prompt=rng.integers(0, vocab, n),
                           max_new_tokens=32) for i, n in enumerate(lens)]

    def recurrentgemma_reqs(arch):
        vocab = get_config(arch).vocab_size
        rng = np.random.default_rng(13)
        lens = [2304, 2304] + [int(n) for n in rng.integers(64, 513, 6)]
        return [GenRequest(rid=i, prompt=rng.integers(0, vocab, n),
                           max_new_tokens=32) for i, n in enumerate(lens)]

    run("llama3.2-3b", llama_reqs,
        {"paged_attention": ("decode", 28),
         "flash_attention_fwd": ("prefill", 28)},
        n_slots=8, max_len=1024, paged=True, page_size=16, prefix_cache=True)
    run("mamba2-2.7b", mamba2_reqs, {"ssd": ("prefill", 64)},
        n_slots=8, max_len=1024, paged=False)
    run("recurrentgemma-2b", recurrentgemma_reqs,
        {"rglru_scan": ("prefill", 18),
         "flash_attention_fwd": ("prefill", 8)},
        n_slots=8, max_len=4096, paged=False)
    check(not failures, "; ".join(failures))


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
