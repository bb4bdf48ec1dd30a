#!/usr/bin/env python3
"""Where the time goes when the PyTorch port serves on one NVIDIA card.

    python3 chip_profile.py

Seven measurements, each printed beside the card's name and power limit:

  pod       the full-width llama3.2-3b pod of ``chip_smoke.py``'s serve
            phase (bfloat16, random seeded weights, paged, prefix cache on,
            decode_chunk 4), warmed with 4 requests, then 4 requests of 512
            prompt tokens and 16 new tokens under torch.profiler: the
            device's busy and idle share of the window, device time by
            kernel, host time by operator
  moe       the same for the full-width moonshot-v1-16b-a3b pod, and the
            host time spent in ``moe_forward`` (router, dispatch, expert
            products, combine) with its kernels' device time
  mamba2    the full-width mamba2-2.7b pod of the serve phase (bfloat16,
            random seeded weights, contiguous slots): its prefill step of a
            512-token prompt (the step a prefill dispatch runs), warmed
            twice, then 4 calls under torch.profiler: the device's busy
            and idle share of that prefill window and the SSD kernel's
            (K5's three device kernels) share of busy time
  rgemma    the same for the full-width recurrentgemma-2b pod (contiguous
            slots, max_len 4096): its prefill step of a 2304-token prompt
            (past the 2048 window), the RG-LRU scan's (K4) and the flash
            kernel's (K2) share of busy time, and K4's device kernels a call
  train     one full-width llama3.2-3b training step (chip_smoke.py's train
            image: float32 params, bf16 compute, remat=full, 2 x 2048
            tokens, ``Container.train_step_fn(donate=True)``), 2 warm-up
            steps, then 2 under torch.profiler: the device's busy and idle
            share, the top device kernels, the flash kernel's (K2 forward
            and its recompute) share and K2's backward kernels' share,
            each summed over its device kernels by name (``flash_*``,
            ``fa2_bwd_*``: a ``record_function`` range around the
            Function's backward did not carry their device time)
  batch     the whole-batch bf16 decode of ``chip_smoke.py``'s batch phase
            (llama3.2-3b, ``Container.prefill_fn`` over 8 prompts of 512
            tokens, then ``decode_fn`` at a scalar position), 2 warm-up steps,
            then 8 under torch.profiler: the device's busy and idle share
            of the window, its top kernels, the host time by operator and
            the launches a step
  spans     the paged-attention kernel at chip_smoke.py's decode shape
            and at the llama pod's (bfloat16): the tensor-core kernel with
            the span plan ``span_pages`` picks, with spans of 4, 8, 16 and
            32 pages, with one span a block (no merge kernel), and the FMA
            kernel with the plan, each held against the plain version;
            CUDA-event medians, L2 flushed

    python3 chip_profile.py batch spans   # only the measurements named

Exits non-zero without a card, or when a check fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

from chip_smoke import (FULL_IMAGEFILE, K1_SHAPE, SRC, TOL, TRAIN_IMAGEFILE,
                        Timer, check, k1_case, k1_pod_case, log,
                        phase_device)


def dev_us(e, total: bool = False) -> float:
    """An event's own device time (with ``total``, its children's too),
    whichever name this torch gives it."""
    names = (("device_time_total", "cuda_time_total") if total else
             ("self_device_time_total", "self_cuda_time_total"))
    for name in names:
        v = getattr(e, name, None)
        if v is not None:
            return float(v)
    return 0.0


def device_summary(prof, wall_us: float, card: str, tag: str,
                   kernels: tuple, ranges: tuple = ()) -> list:
    """Log the window's device busy and idle share, its top kernels and
    the share of each (label, name part) in ``kernels``; return the
    device kernels as (us, name, runs), largest first. ``ranges`` names
    ``record_function`` ranges, whose device-side spans cover kernels
    already counted, so they are left out."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    # device kernels only (host operators also carry their kernels' time)
    device = sorted(((dev_us(e), e.key, e.count) for e in events
                     if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                     and e.key not in ranges), reverse=True)
    check(bool(device), f"{tag}: the profiler recorded no device time")
    busy_us = sum(t for t, _, _ in device)
    log(f"{tag}: window {wall_us / 1e3:.1f} ms wall, device busy "
        f"{busy_us / 1e3:.1f} ms = {100 * busy_us / wall_us:.1f}% "
        f"(idle {100 - 100 * busy_us / wall_us:.1f}%) [{card}]")
    for t, key, n in device[:10]:
        log(f"{tag}: device {t / 1e3:9.3f} ms {100 * t / busy_us:5.1f}% "
            f"x{n:<6d} {key[:90]}")
    for label, name in kernels:
        t = sum(t for t, key, _ in device if name in key)
        n = sum(n for t, key, n in device if name in key)
        log(f"{tag}: {label}: {t / 1e3:.3f} ms = {100 * t / busy_us:.1f}% of "
            f"device busy time, {n} kernel runs")
    return device


@contextmanager
def labelled(torch, module, name: str, label: str | None = None):
    """While entered, every call of ``module.<name>`` runs inside a
    ``torch.profiler.record_function`` range named ``label`` (default:
    ``name``), so the profile holds its host time and its kernels' device
    time."""
    real = getattr(module, name)

    def wrapped(*a, **k):
        with torch.profiler.record_function(label or name):
            return real(*a, **k)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def profile_pod(torch, card: str, workdir: Path, arch: str = "llama3.2-3b",
                tag: str = "pod") -> None:
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.runtime import Runtime
    from repro_torch.models import moe as moe_mod
    from repro_torch.orchestrator import ContinuousScheduler, GenRequest, Pod

    rt = Runtime(workdir / tag)
    rt.build(FULL_IMAGEFILE.format(arch=arch), tag="stable")
    pod = Pod(rt, "stable", replicas=1, n_slots=8, max_len=1024, paged=True,
              page_size=16, prefix_cache=True, decode_chunk=4, seed=0)
    vocab = pod.engines[0].container.arch.vocab_size
    rng = np.random.default_rng(13)

    def serve(rid0: int) -> list:
        reqs = [GenRequest(rid=rid0 + i, prompt=rng.integers(0, vocab, 512),
                           max_new_tokens=16) for i in range(4)]
        sched = ContinuousScheduler(pod)
        sched.submit(reqs)
        sched.run(max_ticks=1000)
        return reqs

    warm = serve(0)              # kernel builds, cuBLAS handles, allocator
    torch.cuda.synchronize()
    with labelled(torch, moe_mod, "moe_forward"), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = serve(100)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(all(r.state == "done" for r in warm + reqs),
          f"{tag}: requests unfinished")

    # the port's kernels by their csrc entry points (K2: both flash kernels)
    device = device_summary(prof, wall_us, card, tag,
                            (("K1 paged_attention", "paged_attention"),
                             ("K2 flash_attention_fwd", "flash_")),
                            ranges=("moe_forward",))
    events = prof.key_averages()
    host = sorted(((float(e.self_cpu_time_total), e.key, e.count)
                   for e in events if e.device_type == DeviceType.CPU),
                  reverse=True)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    log(f"{tag}: {launches} kernel launches from the host in the window")
    for t, key, n in host[:8]:
        log(f"{tag}: host   {t / 1e3:9.3f} ms {100 * t / wall_us:5.1f}% "
            f"x{n:<6d} {key[:90]}")
    moe = [e for e in events if e.key == "moe_forward"]
    if moe:
        busy_us = sum(t for t, _, _ in device)
        e = moe[0]
        dev = dev_us(e, total=True)
        log(f"{tag}: moe_forward x{e.count}: host {e.cpu_time_total / 1e3:.1f}"
            f" ms = {100 * e.cpu_time_total / wall_us:.1f}% of the window, "
            f"its kernels {dev / 1e3:.1f} ms = {100 * dev / busy_us:.1f}% of "
            f"device busy time [{card}]")


def profile_prefill(torch, card: str, workdir: Path, arch: str, tag: str,
                    max_len: int, prompt_len: int, kernels: tuple) -> list:
    """A full-width pod's prefill step of ``prompt_len`` tokens, 2 warm-up
    calls, then 4 under torch.profiler; returns the device kernels."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.runtime import Runtime
    from repro_torch.orchestrator import Pod

    rt = Runtime(workdir / tag)
    rt.build(FULL_IMAGEFILE.format(arch=arch), tag=tag)
    pod = Pod(rt, tag, replicas=1, n_slots=8, max_len=max_len,
              paged=False, seed=0)
    eng = pod.engines[0]
    c = eng.container
    prefill = c.compile_serve_step("prefill_slot", prompt_len=prompt_len,
                                   cache_len=eng.max_len)
    rng = np.random.default_rng(14)
    toks = [torch.as_tensor(rng.integers(0, c.arch.vocab_size,
                                         (1, prompt_len), dtype=np.int32),
                            device=c.device) for _ in range(6)]
    with torch.no_grad():
        for t in toks[:2]:       # kernel builds, cuBLAS handles, allocator
            prefill(eng.params, t, prompt_len)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in toks[2:]:
                prefill(eng.params, t, prompt_len)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    log(f"{tag}: 4 prefills of {prompt_len} tokens, "
        f"{c.arch.n_layers} layers")
    device = device_summary(prof, wall_us, card, tag, kernels)
    for e in pod.engines:
        e.release()
    return device


def profile_mamba2(torch, card: str, workdir: Path) -> None:
    profile_prefill(torch, card, workdir, "mamba2-2.7b", "mamba2", 1024, 512,
                    (("K5 ssd (state, pass and output kernels)", "ssd_"),))


def profile_rgemma(torch, card: str, workdir: Path) -> None:
    from repro_torch.configs import get_config
    cfg = get_config("recurrentgemma-2b")
    device = profile_prefill(
        torch, card, workdir, "recurrentgemma-2b", "rgemma", 4096, 2304,
        (("K4 rglru_scan", "rglru_scan"), ("K2 flash_attention_fwd",
                                           "flash_")))
    rec = cfg.layer_types().count("rec")
    runs = sum(n for _, key, n in device if "rglru_scan" in key)
    log(f"rgemma: K4 device-kernel runs {runs} for {4 * rec} calls (4 "
        f"prefills x {rec} rec layers) = {runs / (4 * rec):.2f} a call "
        f"[{card}]")
    check(runs == 4 * rec, f"rgemma: K4 ran {runs} device kernels for "
                           f"{4 * rec} calls")


def profile_batch(torch, card: str, workdir: Path) -> None:
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import BATCH_B, BATCH_IMAGEFILE, BATCH_PROMPT
    from repro_torch.core.runtime import Runtime
    from repro_torch.serve.serve_step import greedy_sample

    rt = Runtime(workdir / "batch")
    rt.build(BATCH_IMAGEFILE.format(arch="llama3.2-3b", dtype="bfloat16"),
             tag="bf16")
    c = rt.run("bf16")
    params = c.init_params(0)
    vocab = c.arch.vocab_size
    prefill, decode = c.prefill_fn(), c.decode_fn()
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab, (BATCH_B, BATCH_PROMPT)), device=c.device)
    last, cache = prefill(params, toks)
    tok = greedy_sample(last, vocab)[:, None]
    del last

    def step(i: int):
        lg, _ = decode(params, cache, tok, BATCH_PROMPT + i)
        return lg

    for i in range(2):           # allocator, cuBLAS handles
        step(i)
    torch.cuda.synchronize()
    n = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + n):
            lg = step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(bool(torch.isfinite(lg).all()), "batch: decode logits not finite")
    log(f"batch: {n} whole-batch bf16 decode steps of llama3.2-3b "
        f"({BATCH_B} rows at one scalar position, {c.arch.n_layers} "
        f"layers), "
        f"{wall_us / n / 1e3:.3f} ms a step under the profiler")
    device_summary(prof, wall_us, card, "batch", ())
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    log(f"batch: {launches} kernel launches from the host in the window, "
        f"{launches / n:.0f} a step")
    host = sorted(((float(e.self_cpu_time_total), e.key, e.count)
                   for e in events if e.device_type == DeviceType.CPU),
                  reverse=True)
    for t, key, k in host[:8]:
        log(f"batch: host   {t / 1e3:9.3f} ms {100 * t / wall_us:5.1f}% "
            f"x{k:<6d} {key[:90]}")
    del params, cache


def profile_train(torch, card: str, workdir: Path) -> None:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    rt = Runtime(workdir / "train")
    rt.build(TRAIN_IMAGEFILE, tag="train")
    c = rt.run("train")
    params = c.init_params(0)
    opt = c.init_opt_state(params)
    step = c.train_step_fn(donate=True)
    data = SyntheticLM(DataConfig(vocab_size=c.arch.vocab_size,
                                  seq_len=c.cell.seq_len,
                                  global_batch=c.cell.global_batch, seed=0))
    for i in range(2):       # allocator, cuBLAS handles
        params, opt, m = step(params, opt, data.batch(i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 4):
            params, opt, m = step(params, opt, data.batch(i))
        loss = float(m["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    check(loss == loss, "train: the loss is NaN")
    log(f"train: 2 steps of llama3.2-3b ({c.cell.global_batch} x "
        f"{c.cell.seq_len} tokens, remat={c.model.remat}), loss {loss:.4f}, "
        f"{wall_us / 2e6:.3f} s a step under the profiler")
    device_summary(prof, wall_us, card, "train",
                   (("K2 flash_attention_fwd (forward and recompute)",
                     "flash_"),
                    ("K2 flash_attention_bwd (its backward kernels)",
                     "fa2_bwd_")))
    del params, opt, m


def spans(torch, card: str) -> None:
    from repro_torch.kernels._launch import device_sms
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    timer = Timer(torch)
    for name, (args, _) in (("lengths 1..2048", k1_case(torch,
                                                         torch.bfloat16)),
                            ("the llama pod's decode", k1_pod_case(torch))):
        q, k, table = args[0], args[1], args[3]
        mp = table.shape[1]
        plan = ops.span_pages(K1_SHAPE["B"], K1_SHAPE["n_kv"], mp,
                              K1_SHAPE["ps"], device_sms(q.device))
        ref = paged_attention_ref(*args).float()
        runs = [("mma", plan)] + [("mma", s) for s in (4, 8, 16, 32, mp)
                                  if s != plan] + [("fma", plan)]
        for kernel, span in runs:
            out = ops.paged_attention_cuda(*args, span=span, kernel=kernel)
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            check(bool(torch.isfinite(out).all()) and err <= TOL["bfloat16"],
                  f"spans: {kernel} span={span} max_abs_err {err:.3e}")
            ms = timer(lambda: ops.paged_attention_cuda(*args, span=span,
                                                        kernel=kernel))
            n_spans = -(-mp // span)
            log(f"spans: paged_attention {K1_SHAPE} {name} bfloat16 "
                f"kernel {kernel}, span {span} pages"
                f"{' (the plan)' if span == plan else ''} ({n_spans} spans "
                f"of a {mp}-page table, "
                f"{K1_SHAPE['B'] * K1_SHAPE['n_kv'] * n_spans} blocks on "
                f"{device_sms(q.device)} SMs): {ms:.4f} ms, max_abs_err "
                f"{err:.3e} (pool {tuple(k.shape)}) [{card}]")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_profile: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_profile: no port at {SRC / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    runs = {
        "pod": profile_pod,
        "moe": lambda torch, card, wd: profile_pod(
            torch, card, wd, "moonshot-v1-16b-a3b", "moe"),
        "mamba2": profile_mamba2,
        "rgemma": profile_rgemma,
        "batch": profile_batch,
        "train": profile_train,
        "spans": lambda torch, card, wd: spans(torch, card),
    }
    chosen = sys.argv[1:] or list(runs)
    unknown = [n for n in chosen if n not in runs]
    if unknown:
        print(f"chip_profile: unknown measurements {unknown}; choose from "
              f"{list(runs)}", file=sys.stderr)
        return 2
    state = {"card": ""}
    phase_device(torch, state)
    with tempfile.TemporaryDirectory(prefix="chip_profile_") as tmp:
        for name in chosen:
            runs[name](torch, state["card"], Path(tmp))
            torch.cuda.empty_cache()
    print(state["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
