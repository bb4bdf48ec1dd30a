#!/usr/bin/env python3
"""Where the time goes when the PyTorch port serves on one NVIDIA card.

    python3 chip_profile.py

Ten measurements, each printed beside the card's name and power limit:

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
  ssd_bwd   K5's backward (one ``ssd_bwd_cuda`` call) at the train phase's
            shape GRAD_K5 and at the dist phase's (d) mamba2-2.7b rank
            shape K5_TP: the call's CUDA-event median (L2 flushed), then
            10 calls under torch.profiler after 3 warm-up calls, each
            device kernel's time a call summed by kernel name, with its
            share of the call's device time, and the call's span from its
            first kernel's start to its last kernel's end (the gaps
            between its kernels included); the route the call took
  fwd       K2's forward at every shape that chip_smoke.py runs on the
            wgmma kernels: bfloat16 at head dims 64, 128 and 256 (K2_CASES,
            K2_BATCH, the bf16 K2_EXAMPLES, the dist ranks' K2_TP, K2_FSDP
            and K2_DP, the train phase's GRAD_K2, the recurrentgemma pod's
            prefills) and float32 at 64 and 128 (K2_BATCH, (g)'s K2_G, the
            float32 K2_BWD, (f)'s and (i)'s prefills): each kernel the
            launcher can run there -- the first version (mma.sync in bf16,
            FMA in float32), the wgmma kernel with 64- and 128-row blocks --
            held against the plain version, then timed in turns (first, 64,
            128, 128, 64, first; CUDA-event medians, L2 flushed) beside the
            kernel the shapes choose, the bound (for float32 at the FMA rate
            and at 3xBF16's) and SDPA's forward (``sdpa_mask``, GQA through
            ``enable_gqa``); for float32 the chosen kernel's two device
            kernels (the parts, the attention) apart under torch.profiler
  bwd       K2's backward at every K2_BWD and rank shape of the routes
            redesigned in PR 34 (bfloat16 at d 256, float32 at d 64 and
            128): the route's kernels and the first version they replaced
            (mma.sync, FMA), each held against the dense float32 plain
            backward, then timed in turns (new, old, old, new; CUDA-event
            medians, L2 flushed) beside the bound (for float32 at the FMA
            rate and at 3xBF16's) and SDPA's backward (``sdpa_mask``); then
            the new route's split: its dK/dV blocks alone and its dQ blocks
            alone (the launcher's ``only``), and under torch.profiler the
            call's device kernels by name

    python3 chip_profile.py batch spans   # only the measurements named

Exits non-zero without a card, or when a check fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

from chip_smoke import (FULL_IMAGEFILE, GRAD_K2, GRAD_K5, K1_SHAPE, K2_BATCH,
                        K2_BWD, K2_BWD_RANKS, K2_BWD_TOL, K2_CASES, K2_DP,
                        K2_EXAMPLES, K2_FSDP, K2_G, K2_TP, K5_TP, SRC, TOL,
                        TRAIN_IMAGEFILE, Timer, _pod_tp_shapes, check, k1_case,
                        k1_pod_case, k2_bound, k2_bwd_bound, log,
                        phase_device, sdpa_mask)


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


def ssd_bwd_split(torch, card: str) -> None:
    import re

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd import ops as ssd_ops

    timer = Timer(torch)
    calls = 10
    for case in ((*GRAD_K5[0], GRAD_K5[1]), *K5_TP):
        b, S, H, P, N, Q = case
        rng = np.random.default_rng(5)
        t = lambda a: torch.from_numpy(                    # noqa: E731
            np.asarray(a, np.float32)).to("cuda")
        x = t(rng.standard_normal((b, S, H, P)))
        dt = t(np.log1p(np.exp(rng.standard_normal((b, S, H)) - 1.0)))
        A = t(-np.exp(0.5 * rng.standard_normal(H)))
        B = t(rng.standard_normal((b, S, N)))
        C = t(rng.standard_normal((b, S, N)))
        gy = t(rng.standard_normal((b, S, H, P)))
        run = lambda: ssd_ops.ssd_bwd_cuda(x, dt, A, B, C, Q, gy)  # noqa: E731
        ms = timer(run)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        by_name: dict[str, list] = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or dev_us(e) <= 0:
                continue
            m = re.search(r"(\w+_kernel\w*)", e.key)
            name = m.group(1) if m else e.key[:60]
            acc = by_name.setdefault(name, [0.0, 0])
            acc[0] += dev_us(e)
            acc[1] += e.count
        check(bool(by_name), "ssd_bwd: the profiler recorded no device time")
        total = sum(us for us, _ in by_name.values())
        # each call's kernels in launch order: first start to last end
        runs = sorted((e.time_range.start, e.time_range.end)
                      for e in prof.events() if e.device_type == DeviceType.CUDA)
        per = len(runs) // calls
        span = sum(runs[k * per + per - 1][1] - runs[k * per][0]
                   for k in range(calls)) / calls
        tag = "ssd_bwd b={} S={} H={} P={} N={} chunk={}".format(*case)
        log(f"{tag}: route {ssd_ops.bwd_route(P, N, Q)}; one call {ms:.4f} "
            f"ms (CUDA events, median, L2 flushed); under the profiler "
            f"device kernels {total / calls / 1e3:.4f} ms a call, first "
            f"start to last end {span / 1e3:.4f} ms ({per} kernels) [{card}]")
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
            log(f"{tag}: {name:32s} {us / calls / 1e3:8.4f} ms a call "
                f"{100 * us / total:5.1f}%  x{n // calls}")
        del x, dt, A, B, C, gy
        torch.cuda.empty_cache()


# K2 at the recurrentgemma-2b pod's prefills (bf16, exact prompt lengths
# of 64-512 tokens, one kv head of 256, window 2048): where 64-row blocks
# give the card more work items than 128-row ones
RGEMMA_POD_K2 = tuple((1, 10, 1, 256, S, S, 2048) for S in (64, 256, 512))


def fwd_kernels(torch, card: str) -> None:
    import re

    import numpy as np
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    timer = Timer(torch)
    bf16 = ([(1, *c) for c in K2_CASES] + list(K2_BATCH)
            + [c[:-1] for c in (*K2_EXAMPLES, *K2_TP, *K2_FSDP, *K2_DP)
               if c[-1] == "bfloat16"]
            + [(B, Hq, Hkv, d, S, S, w) for B, Hq, Hkv, S, d, w in GRAD_K2]
            + list(RGEMMA_POD_K2))
    f32 = ([(*c, "float32") for c in K2_BATCH]
           + [c for c in (*K2_G, *K2_BWD, *_pod_tp_shapes()["k2"])
              if c[-1] == "float32"])
    shapes = sorted({(*s, "bfloat16") for s in bf16 if s[3] in (64, 128, 256)}
                    | {s for s in f32 if s[3] in (64, 128)},
                    key=lambda s: (s[7], s[3], s[0] * s[1] * s[4], s))

    def inputs(B, Hq, Hkv, d, Sq, Sk, dt):
        r = np.random.default_rng(2)
        return [torch.from_numpy(r.standard_normal(shape).astype(
            np.float32)).to("cuda", dt) for shape in (
            (B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d))]

    def sdpa(q, k, v, Sq, Sk, window):
        mask = sdpa_mask(torch, Sq, Sk, window)
        return timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True))

    for B, Hq, Hkv, d, Sq, Sk, window, dname in shapes:
        dt = getattr(torch, dname)
        q, k, v = inputs(B, Hq, Hkv, d, Sq, Sk, dt)
        kw = dict(causal=True, window=window)
        ref = flash_attention_ref(q, k, v, **kw).float()
        first = "fma" if dname == "float32" else "mma.sync"
        kernels = (first, "wgmma-64", "wgmma-128")
        errs = {}
        for kern in kernels:
            out = fa_ops.flash_attention_fwd_cuda(q, k, v, kernel=kern, **kw)
            torch.cuda.synchronize()
            errs[kern] = float((out.float() - ref).abs().max())
            check(bool(torch.isfinite(out).all()) and errs[kern] <= TOL[dname],
                  f"fwd: {kern} at {(B, Hq, Hkv, d, Sq, Sk, window, dname)} "
                  f"max_abs_err {errs[kern]:.3e}")
        del ref, out
        times = {kern: [] for kern in kernels}
        for kern in (*kernels, *reversed(kernels)):
            times[kern].append(timer(lambda: fa_ops.flash_attention_fwd_cuda(
                q, k, v, kernel=kern, **kw)))
        chosen = fa_ops.fwd_kernel(dt, d, B, Hq, Sq)
        bms, by = k2_bound(B, Hq, Hkv, d, Sq, Sk, window, q.element_size(),
                           dname)
        bound = f"bound {bms:.4f} ms ({by}"
        if dname == "float32":
            tc = k2_bound(B, Hq, Hkv, d, Sq, Sk, window, 4, "bfloat16",
                          products=3)[0]
            bound += f" at the f32 FMA rate; {tc:.4f} ms at 3xBF16's"
        lib = sdpa(q, k, v, Sq, Sk, window)
        log(f"fwd: flash_attention_fwd B={B} Hq={Hq} Hkv={Hkv} d={d} Sq={Sq} "
            f"Sk={Sk} window={window} {dname} (route "
            f"{fa_ops.fwd_route(dt, d)}): "
            + ", ".join(f"{kern} {t[0]:.4f} / {t[1]:.4f} ms (err "
                        f"{errs[kern]:.2e})" for kern, t in times.items())
            + f"; chosen {chosen}; {bound}); SDPA {lib:.4f} ms [{card}]")
        if dname == "float32":
            # the 3xBF16 route's two device kernels (the parts, then the
            # attention) apart, under the profiler
            calls = 5
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fa_ops.flash_attention_fwd_cuda(q, k, v, **kw)
                torch.cuda.synchronize()
            by_name: dict[str, list] = {}
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA or dev_us(e) <= 0:
                    continue
                m = re.search(r"(flash_\w+?)(?:<|\(|$)", e.key)
                acc = by_name.setdefault(m.group(1) if m else e.key[:40],
                                         [0.0, 0])
                acc[0] += dev_us(e)
                acc[1] += e.count
            check(bool(by_name), "fwd: the profiler recorded no device time")
            log(f"fwd: B={B} Hq={Hq} Hkv={Hkv} d={d} Sq={Sq} {dname} "
                f"{chosen} under the profiler, device kernels a call: "
                + ", ".join(f"{name} {us / calls / 1e3:.4f} ms x{n // calls}"
                            for name, (us, n) in sorted(
                                by_name.items(), key=lambda kv: -kv[1][0])))
        del q, k, v
        torch.cuda.empty_cache()


def bwd_kernels(torch, card: str) -> None:
    import re

    import numpy as np
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels._launch import device_sms
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref,
        flash_attention_ref)

    timer = Timer(torch)
    shapes = sorted({c for c in (*K2_BWD, *K2_BWD_RANKS)
                     if (c[7], c[3]) in (("bfloat16", 256), ("float32", 64),
                                         ("float32", 128))},
                    key=lambda c: (c[7], c[3], c[0] * c[1]))
    for B, Hq, Hkv, d, Sq, Sk, window, dname in shapes:
        dt = getattr(torch, dname)
        r = np.random.default_rng(3)
        q, k, v, dout = (torch.from_numpy(r.standard_normal(shape).astype(
            np.float32)).to("cuda", dt) for shape in (
            (B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d),
            (B, Hq, Sq, d)))
        kw = dict(causal=True, window=window)
        out, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, lse=True, **kw)
        f = [t.float() for t in (q, k, v)]
        want = flash_attention_bwd_ref(
            *f, flash_attention_ref(*f, **kw),
            flash_attention_lse_ref(*f[:2], **kw), dout.float(), **kw)
        new = fa_ops.bwd_route(dt, d)
        old = "mma.sync" if dname == "bfloat16" else "fma"
        tag = (f"bwd: B={B} Hq={Hq} Hkv={Hkv} d={d} Sq={Sq} Sk={Sk} "
               f"window={window} {dname}")

        def call(kern, only=0):
            return fa_ops.flash_attention_bwd_cuda(
                q, k, v, out, lse, dout, kernel=kern, only=only, **kw)

        errs = {}
        for kern in (new, old):
            got = call(kern)
            torch.cuda.synchronize()
            errs[kern] = max(float((a.float() - b).abs().max())
                             / float(b.abs().max())
                             for a, b in zip(got, want))
            check(all(bool(torch.isfinite(a).all()) for a in got)
                  and errs[kern] <= K2_BWD_TOL[dname],
                  f"{tag}: {kern} max_abs_err {errs[kern]:.2e} of max")
        del want, f, got
        times = {new: [], old: []}
        for kern in (new, old, old, new):
            times[kern].append(timer(lambda: call(kern)))
        split = [timer(lambda: call(new, only)) for only in (1, 2)]
        bms, by = k2_bwd_bound(B, Hq, Hkv, d, Sq, Sk, window, 2 if
                               dname == "bfloat16" else 4, dname)
        bound = f"bound {bms:.4f} ms ({by}"
        if dname == "float32":
            tc = k2_bwd_bound(B, Hq, Hkv, d, Sq, Sk, window, 4, "bfloat16",
                              products=3)[0]
            bound += f" at the f32 FMA rate; {tc:.4f} ms at 3xBF16's"
        xs = [t.detach().requires_grad_() for t in (
            q, k.repeat_interleave(Hq // Hkv, dim=1),
            v.repeat_interleave(Hq // Hkv, dim=1))]
        mask = sdpa_mask(torch, Sq, Sk, window)
        o = F.scaled_dot_product_attention(*xs, attn_mask=mask,
                                           is_causal=mask is None)
        lib = timer(lambda: torch.autograd.grad(o, xs, dout,
                                                retain_graph=True))
        parts = fa_ops.group_splits(B, Hkv, Sk, Hq // Hkv,
                                    fa_ops.bwd_key_block(dt, d),
                                    device_sms(q.device))
        log(f"{tag}: {new} {times[new][0]:.4f} / {times[new][1]:.4f} ms (max "
            f"err {errs[new]:.2e} of max), {old} {times[old][0]:.4f} / "
            f"{times[old][1]:.4f} ms (max err {errs[old]:.2e}); {bound}); "
            f"SDPA backward {lib:.4f} ms"
            f"{'' if mask is None else ' (boolean mask)'}; the group in "
            f"{parts} part(s) [{card}]")
        log(f"{tag}: {new} dK/dV blocks alone {split[0]:.4f} ms, dQ blocks "
            f"alone {split[1]:.4f} ms (each with the call's other kernels)")
        del xs, o, mask
        calls = 5
        for _ in range(2):
            call(new)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call(new)
            torch.cuda.synchronize()
        by_name: dict[str, list] = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or dev_us(e) <= 0:
                continue
            m = re.search(r"(fa2_bwd_\w+?)(?:<|\(|$)", e.key)
            name = m.group(1) if m else e.key[:40]
            acc = by_name.setdefault(name, [0.0, 0])
            acc[0] += dev_us(e)
            acc[1] += e.count
        check(bool(by_name), f"{tag}: the profiler recorded no device time")
        total = sum(us for us, _ in by_name.values())
        log(f"{tag}: {new} under the profiler {total / calls / 1e3:.4f} ms "
            f"of device kernels a call: " + ", ".join(
                f"{name} {us / calls / 1e3:.4f} ms x{n // calls}"
                for name, (us, n) in sorted(by_name.items(),
                                            key=lambda kv: -kv[1][0])))
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()


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
        "ssd_bwd": lambda torch, card, wd: ssd_bwd_split(torch, card),
        "fwd": lambda torch, card, wd: fwd_kernels(torch, card),
        "bwd": lambda torch, card, wd: bwd_kernels(torch, card),
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
