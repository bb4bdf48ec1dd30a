#!/usr/bin/env python3
"""Where the time goes when the PyTorch port serves on one NVIDIA card.

    python3 chip_profile.py

Two measurements, each printed beside the card's name and power limit:

  pod       the full-width llama3.2-3b pod of ``chip_smoke.py``'s serve
            phase (bfloat16, random seeded weights, paged, prefix cache on,
            decode_chunk 4), warmed with 4 requests, then 4 requests of 512
            prompt tokens and 16 new tokens under torch.profiler: the
            device's busy and idle share of the window, device time by
            kernel, host time by operator
  split-K   the paged-attention kernel at chip_smoke.py's decode shape
            (bfloat16), in one pass (n_split=1) and with the split it picks
            itself (a second kernel merges the splits), each held against
            the plain version; CUDA-event medians, L2 flushed

Exits non-zero without a card, or when a check fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

from chip_smoke import (FULL_IMAGEFILE, K1_SHAPE, SRC, TOL, Timer, check,
                        k1_case, log, phase_device)


def profile_pod(torch, card: str, workdir: Path) -> None:
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.runtime import Runtime
    from repro_torch.orchestrator import ContinuousScheduler, GenRequest, Pod

    rt = Runtime(workdir / "full")
    rt.build(FULL_IMAGEFILE.format(arch="llama3.2-3b"), tag="stable")
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = serve(100)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(all(r.state == "done" for r in warm + reqs),
          "pod: requests unfinished")

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0

    events = prof.key_averages()
    # device kernels only (host operators also carry their kernels' time)
    device = sorted(((dev_us(e), e.key, e.count) for e in events
                     if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                    reverse=True)
    busy_us = sum(t for t, _, _ in device)
    check(bool(device), "pod: the profiler recorded no device time")
    log(f"pod: window {wall_us / 1e3:.1f} ms wall, device busy "
        f"{busy_us / 1e3:.1f} ms = {100 * busy_us / wall_us:.1f}% "
        f"(idle {100 - 100 * busy_us / wall_us:.1f}%) [{card}]")
    for t, key, n in device[:10]:
        log(f"pod: device {t / 1e3:9.3f} ms {100 * t / busy_us:5.1f}% "
            f"x{n:<6d} {key[:90]}")
    # the port's kernels by their csrc entry points (K2: both flash kernels)
    for label, prefix in (("K1 paged_attention", "paged_attention"),
                          ("K2 flash_attention_fwd", "flash_")):
        t = sum(t for t, key, _ in device if prefix in key)
        n = sum(n for t, key, n in device if prefix in key)
        log(f"pod: {label}: {t / 1e3:.3f} ms = {100 * t / busy_us:.1f}% of "
            f"device busy time, {n} kernel runs")
    host = sorted(((float(e.self_cpu_time_total), e.key, e.count)
                   for e in events if e.device_type == DeviceType.CPU),
                  reverse=True)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    log(f"pod: {launches} kernel launches from the host in the window")
    for t, key, n in host[:8]:
        log(f"pod: host   {t / 1e3:9.3f} ms {100 * t / wall_us:5.1f}% "
            f"x{n:<6d} {key[:90]}")


def split_k(torch, card: str) -> None:
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    args, _ = k1_case(torch, torch.bfloat16)
    q, k = args[0], args[1]
    auto = ops._lib().paged_attention_num_splits(
        K1_SHAPE["B"], K1_SHAPE["n_kv"], args[3].shape[1], K1_SHAPE["ps"],
        K1_SHAPE["hd"], ops._sms(q.device))
    ref = paged_attention_ref(*args).float()
    timer = Timer(torch)
    for n_split in (1, auto):
        out = ops.paged_attention_cuda(*args, n_split=n_split)
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        check(bool(torch.isfinite(out).all()) and err <= TOL["bfloat16"],
              f"split-K: n_split={n_split} max_abs_err {err:.3e}")
        ms = timer(lambda: ops.paged_attention_cuda(*args, n_split=n_split))
        log(f"split-K: paged_attention {K1_SHAPE} lengths 1..2048 bfloat16 "
            f"n_split={n_split}: {ms:.4f} ms, max_abs_err {err:.3e} "
            f"({K1_SHAPE['B'] * K1_SHAPE['n_kv'] * n_split} blocks on "
            f"{ops._sms(q.device)} SMs; pool {tuple(k.shape)}) [{card}]")


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
    state = {"card": ""}
    phase_device(torch, state)
    with tempfile.TemporaryDirectory(prefix="chip_profile_") as tmp:
        profile_pod(torch, state["card"], Path(tmp))
    split_k(torch, state["card"])
    print(state["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
