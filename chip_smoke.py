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
            times; each K3 row names the kernel (wgmma or fma) and tile
            ``kernel_choice`` took, and at llama3.2-3b's MLP products the
            kernel's other tile is timed beside it; K1 (paged decode) is
            also timed on its FMA kernel with the same span plan and at the
            llama pod's own decode (lengths 64-544), K5 (SSD) at the mamba2
            pod's shortest and longest prefills (S 64 and 768), with the
            bound of its 3xTF32 tensor-core arithmetic beside the float32
            one; K1 at the decodes of the stablelm-3b, nemotron-4-15b
            (GQA group 6), moonshot-v1-16b-a3b, musicgen-medium (hd 64)
            and internvl2-2b pods; K2 at stablelm-3b's head dim 80 (its
            512-token and suffix prefills), nemotron-4-15b's 512-token
            prefill (48 over 8 heads) and musicgen-medium's packed prefill
            of 64 + 512 rows, each beside SDPA; K4 (RG-LRU) at
            the recurrentgemma pod's prefills (S 64, 512, 2304), each
            call held bit for bit against a second one, and its reverse
            scan (the backward's adjoint recurrence) at each of those
            shapes against the plain reverse scan, bit for bit against a
            second call; K2's backward kernels, from the forward kernel's
            out and L, at every shape a training path gives them (float32
            and bf16) against the dense float32 plain backward, each line
            naming the route the .cu chose (wgmma, mma.sync or fma; a
            bf16 call at d 64 or 128 off the wgmma route fails), the
            ranks' shapes timed beside SDPA's backward (a phase, or a
            rank, that runs the backward at another shape fails); K5's
            backward kernels at the train phase's 1 x 1024 x 80 x 64 x
            128 and (d)'s rank shape 2 x 2048 x 40 x 64 x 128 (chunk 256)
            against the plain backward ``ssd_bwd_ref``: every grad within
            1e-4 of its largest, the same bits from two calls, timed
            beside ``cost_bwd``'s bound and the plain backward
  fig5      the fig5 tuned-kernel analog (benchmarks/fig5_tuned_kernel.py)
            on the card: the blocked matmul called natively (blocks named:
            platform "h100") and through a container bound from an
            Imagefile (blocks resolved from the tensor's device when the
            call is made), host microseconds a call, outputs bit for bit
            equal; at the benchmark's 256^3 float32 shape and llama3.2-3b's
            prefill MLP products (bf16 and f32); flash attention through K2
            against its plain version at the benchmark's shape
  parity    the smoke reductions in float32, served on the card and on the
            CPU with the same weights, per-request tokens identical:
            llama3.2-3b-smoke (12-request paged trace, prefix cache on),
            mamba2-2.7b-smoke and recurrentgemma-2b-smoke (contiguous
            slots; recurrentgemma's prompts pass its 16-token window);
            nemotron-4-15b-smoke and moonshot-v1-16b-a3b-smoke (MoE) on
            llama's trace; musicgen-medium-smoke and internvl2-2b-smoke
            (paged, 12 requests with none, part or all of the 4-row
            frontend buffer);
            and llama3.2-3b-smoke served on the card by launch/serve.main
            in continuous and in static mode, tokens identical
  serve     eight full-width pods, bfloat16, random weights from seed 0,
            behind Runtime -> Pod -> ContinuousScheduler, 32 new tokens a
            request, no EOS:
              llama3.2-3b (28 layers), paged, prefix cache on, 16 requests;
              stablelm-3b (32 layers, 32 heads of 80, LayerNorm, partial
                rotary), the same pod and trace;
              mamba2-2.7b (64 ssm layers), contiguous, 12 requests of
                64-768 prompt tokens;
              recurrentgemma-2b (18 rec + 8 local-attention layers),
                contiguous, max_len 4096, 8 requests, 2 of them 2304-token
                prompts past the 2048 window;
              nemotron-4-15b (32 layers, 48 q / 8 kv heads, squared ReLU),
                the llama pod and trace;
              moonshot-v1-16b-a3b (48 layers: 1 dense + 47 MoE of 64
                experts, top 6, 2 shared), the llama pod and trace, with
                the assignments each prefill dropped to capacity;
              musicgen-medium (48 layers, 24 heads of 64, 64-row audio
                frontend) and internvl2-2b (24 layers, 256-row vision
                frontend), paged, prefix cache off, 12 requests of 64-512
                prompt tokens: 4 with the full frontend, 4 with part, 4
                with none;
            each pod's kernel launch counts must match the dispatches its
            scheduler ran, every request completes with 32 tokens, the
            logits are finite, and the peak memory is printed
  batch     the whole-batch serve path (``Container.prefill_fn`` /
            ``decode_fn``, tests/test_consistency.py's flow) at full width,
            ``SHAPE prefill_32k seq_len=1024 global_batch=8``, random
            weights from seed 0: (a) float32 llama3.2-3b, mamba2-2.7b and
            recurrentgemma-2b, 8 prompts of 512 tokens: one prefill (K2 =
            28; K2 = 8 and K4 = 18; K5 = 64, nothing else), the
            ``generate`` step of 32 from the scalar start 512 and
            ``decode_fn`` stepped 4 times at a 0-d position (no kernel
            launched); the hand-stepped tokens equal the loop's, and each
            request's 33 tokens equal a contiguous ``Pod(n_slots=8,
            max_len=1024)``'s on the same prompts (else the top-2 margins
            at the first difference are printed); (b) bf16 llama3.2-3b,
            the native route (``Model`` + ``ServeStepBuilder``) against
            the container route on the same params: last logits and 8
            decode steps bit-identical; each route's prefill and one
            decode step timed (median of 5, CUDA events, the routes
            interleaved) with their ratio
  cli       the user's entry points in process (``repro_torch.cli.main``)
            on full-width llama3.2-3b (bf16, random weights from seed 0) in
            a temporary root: build, images, inspect; serve with two pods
            behind the prefix-hash router (paged, prefix cache, a 256-token
            shared prompt, 32 requests of up to 512 + 256 prompt tokens, a
            Chrome trace); serve --mode static (16 requests in waves of 8);
            ps, top, and the trace validator. Every command exits 0, every
            request completes, the prefix cache hits, and K1/K2 launches
            equal layers x the dispatches the engines ran
  examples  (a) the port's linter: ``python -m repro_torch.cli lint
            --strict --ratchet lint-ratchet.json src tests`` in a process
            whose PYTHONPATH starts with a directory where ``import jax``
            and ``import repro`` raise: exit 0, no finding; then on a copy
            of the port's ``obs/tracing.py`` with a span kind added to
            ``SPAN_KINDS`` (and to its exporter) and no transition: exactly
            one span-lifecycle error; (b) the four examples
            (``repro_torch.examples``) in process through their
            ``main(argv)``, on the card at their own configurations, each
            root deleted after it: quickstart (15 steps of
            llama3.2-3b-smoke, a checkpoint and a resume) and
            hpc_migration (10 steps, the host-ABI image pushed as 2 new
            layers and 8 reused, a reshard restore): losses finite, the
            last below the first; serve_batched (a 6-layer llama, 8
            requests): every request gets its budget; train_100m (0.10 B
            params, 300 steps, a checkpoint every 50): losses finite, the
            last below the first. K2 = layers x training steps (no
            remat) or layers x prefills, and nothing else; seconds, peak
            memory and train_100m's tokens/s printed
  fabric    the cross-host fabric on full-width llama3.2-3b in float32
            (the reference harness's precision), 16 requests of 64-512
            prompt tokens and 32 new, 4 arriving a tick, against one pod
            and scheduler serving the same trace (the oracle): (a) two
            loopback pods, (b) the same with one killed
            (``transport.kill()``) once it holds a request with 16
            committed tokens, (c) two worker processes
            (``proc_spawner``, each its own CUDA context), one killed
            with SIGKILL there, the fleet healing to two; (d) ``serve
            --fabric proc`` through the CLI on the bf16 image, then ps and
            top. Tokens equal the oracle's in (a)-(c) (else the rid, the
            position and the oracle's top-2 margin there are printed); K1
            = 28 x decode steps and K2 = 28 x prefills (resumes included)
            over every member of (a) and (b); one eviction in (b) and (c),
            each rerouted rid rerouted once, closure routed == closed (c:
            from the span files, and ``validate --spans`` exits 0); every
            worker holds the card's device node open and the card's
            memory grows by more than its weights a worker; boot seconds,
            kill to eviction and wall seconds printed
  train     (a) K2, K4 and K5 as ``torch.autograd.Function``s at the
            shapes training gives them (K2 at llama3.2-3b's 2 x 24/8 x 2048
            x 128 and recurrentgemma-2b's 1 x 10/1 x 2048 x 256 window
            2048, bf16; K4 at 1 x 2048 x 2560; K5 at 1 x 1024 x 80 x 64 x
            128, chunk 256, f32): output and input grads against the plain
            version under autograd, the Functions run with their plain
            versions made to raise (K2's backward its backward kernels
            from the saved L, K4's one reverse scan, K5's its backward
            kernels); K2's grads
            within 2^-7 of the largest gradient of a dense float32 plain
            backward and the same bits from two calls; forward and
            backward times (K2's backward kernels beside their bound
            (``cost_bwd``), their route, the plain backward and SDPA's
            backward; K4's and K5's backward beside their bound, K5's
            also beside the plain vjp, the backward before K5's kernels,
            timed in the same run); (b)
            five smoke reductions (llama, mamba2,
            recurrentgemma, moonshot, musicgen) trained 3 steps on the card
            and on the CPU from the same weights and batches, float32:
            losses and grad norms agree, the card runs their kernels and
            the CPU none, K2's backward kernels once a step per attention
            layer, K4's reverse scan once a step per rec layer and K5's
            backward kernels once a step per ssm layer, with no plain
            version of K2, K4 or K5 on the card; (c) full-width llama3.2-3b
            cut to 8 layers
            (float32 params, bf16 compute, remat=full, 2 x 2048 tokens)
            through
            ``repro_torch.cli run --steps 2 --keep 1`` (its closing
            checkpoint), then ``run --resume --steps 1``: finite losses,
            the resumed run starts at step 2 and its step 3 equals a
            straight 3-step run's (``Container.train_step_fn``), K2
            launches = 8 x 2 x steps, K2's backward 8 x steps and nothing
            else, peak memory under
            80 GB; step seconds, tokens/s and the model-FLOPs share of 989
            TFLOP/s printed; each kernel's forward beside its bound at
            the training shape
  dist      data-parallel training across processes, through ``torchrun
            -m repro_torch.cli run`` (run as ``python -m
            torch.distributed.run --standalone``): (a) one NCCL rank,
            llama3.2-3b at full width cut to 2 layers (the train phase's
            settings), 2 steps under ``generic`` and 2 under ``host``: the
            losses equal one process's on the same image within 1e-6, K2
            = 2 x 2 x steps, the backend is nccl; (b) two gloo ranks
            sharing the card, llama3.2-3b at full width cut to 2 of 28
            layers, one 2048-token row a rank, 3 steps under each of
            ``generic``, ``host`` (ZeRO-1) and ``host mode=explicit``
            (bf16 wire): losses and grad norms equal one process on the
            same global batch in two microbatches of one row, the ranks'
            arithmetic (1e-3; 1e-2 for the bf16 wire), K2 = 2 x 2
            x steps in each rank, each rank holds the card's device node
            open while it runs; (c) (b)'s host checkpoint of step 2 (two
            ZeRO-1 halves) restored onto one process: its step 3 equals
            (b)'s within 1e-3; (d) tensor parallelism: two gloo ranks
            sharing the card under ``torchrun --nproc-per-node 2
            chip_smoke.py --tp-worker``, each building the (data 1, model
            2) mesh and the port's train step over it, 3 generic steps
            at full width of llama3.2-3b and moonshot-v1-16b-a3b (its
            dense layer and one MoE layer: 32 experts a rank) cut to 2
            layers, mamba2-2.7b cut to 2 (40 of 80 heads a rank) and
            recurrentgemma-2b cut to one rec, rec, attn cycle (1280 of
            2560 RG-LRU channels, 5 of 10 q heads a rank), both rows of
            the 2 x 2048 global batch on each rank: every rank's loss
            equal, losses and grad norms within 1e-3 relative of one
            process, launches a rank exactly 2 x steps per attention
            (K2), rec (K4) and ssm (K5) layer, K4's reverse scan and K5's
            backward kernels once a step per rec or ssm layer, and nothing
            else, each at
            a per-rank shape the kernels phase held to its plain version
            (K2_TP, K4_TP, K5_TP), the model axis's bytes a step equal
            to ``tp_wire_bytes``, each rank holds the card's device node
            open; (e) weight FSDP in the same torchrun job: a (data 2,
            model 1) mesh, llama3.2-3b at (b)'s 2 layers, one row a rank,
            3 steps under ``generic`` + ``fsdp=true`` and the paper's
            Fig. 3 host arm (``host`` + ``fsdp=true`` + ``remat=dots``):
            losses and grad norms within (b)'s bounds of (b)'s
            two-microbatch process, the ABI's bytes a step a rank equal
            to ``fsdp_wire_bytes``, peak memory a rank below (b)'s rank
            of the same ABI, K2 = 2 x 2 x steps a rank at K2_FSDP; (f)
            serving on the model axis in the same torchrun job: each rank
            builds a port ``Pod`` on the (data 1, model 2) mesh and runs
            the same ``ContinuousScheduler`` over the same requests, in
            float32: llama3.2-3b at full width and full depth (28 layers,
            paged, page 16, 8 slots, prefix cache) on 8 of the serve
            phase's requests (64-512 tokens, 4 sharing a prefix), 32 new
            tokens each, decode chunk 4, then recurrentgemma-2b cut to one
            rec, rec, attn cycle and mamba2-2.7b cut to 2 layers
            (contiguous, 4 prompts each): every request done, every
            rank's tokens and admit ticks equal, llama's equal to one
            float32 process's Pod on the same requests (run first and
            released), launches a rank exactly K1 = 28 x decode steps and
            K2 = 28 x prefills (K4 2 and K2 1 x prefills, K5 2 x
            prefills) and nothing else, each at a per-rank shape the
            kernels phase held to its plain version (``_pod_tp_shapes``:
            K1 at 12 q over 4 kv heads), each rank on the card; (g)
            PowerSGD on the model axis in the same job: llama3.2-3b at
            6 layers in float32 compute on the (data 1, model 2) mesh,
            ``host mode=explicit
            grad_compression=float32 compression=powersgd rank=1``, both
            rows on each rank, 3 steps: leaves compressed on each of
            ``powersgd_sync``'s branches (rows, columns, strided columns:
            ``powersgd_splits``), losses and grad norms within 1e-3
            relative of one process's PowerSGD steps at model 1 (the same
            initial Q), the model axis's PowerSGD bytes a step =
            ``powersgd_wire_bytes``, TP bytes = ``tp_wire_bytes`` (4-byte
            activations), K2 at K2_G; (h) the MoE over data replicas: a (data 2, model 1)
            mesh, moonshot-v1-16b-a3b at (d)'s 2 layers (64 experts whole
            a rank), generic, one 2048-token row a rank, 3 steps: the
            dispatch's positions and capacity over the global batch,
            losses and grad norms within 1e-3 relative of (d)'s one
            process on both rows in one microbatch, the dropped
            assignments equal at step 1 (later steps within 1e-3 of the
            routed, ``DIST_H_DROPS``), ABI bytes a step =
            ``generic_wire_bytes``, the count gathers' bytes a step =
            ``moe_count_bytes``, K2 at K2_DP; (i) a Pod with a batch
            axis: (f)'s llama3.2-3b Pod on the (data 2, model 1) mesh,
            each rank holding and decoding 4 of the 8 slots and gathering
            every slot's tokens a decode dispatch: tokens and admit ticks
            equal on both ranks and to (f)'s one float32 process, K1 = 28
            x decode steps at K1_DP and K2 = 28 x prefills a rank (the
            prefill whole on each rank), the gather's bytes = dispatches x
            8 x chunk x 4.
            Printed: step seconds a rank, collective seconds and wire
            bytes a step (the port's counter), peak memory a rank
            (beside one process's in (d) and (f)), the card's memory in
            use while (b), (d)-(i) run; for (f) decode tokens/s
            a rank and the model axis's seconds and bytes a decode step
            and token; for (i) decode tokens/s a rank, the gather's bytes
            a decode dispatch and peak memory a rank
  dryrun    the port's dry run (``repro_torch.launch.dryrun``: one rank
            of a job of fake ranks traced on the meta device under the
            counter, at H100 data-sheet constants): (a) the paper's
            Fig. 3 at its scale, deepseek-67b ``train_4k`` under generic
            and the host arm (host + fsdp, ``--tag host``) and
            llama4-scout-17b-a16e generic, on the pod (256) and multipod
            (512) meshes, six processes with no card visible: every cell
            ok, model FLOPs equal to ``model_flops``, the useful and
            roofline fractions in (0, 1], cross-pod bytes 0 at pod and
            above 0 at multipod, deepseek-67b's host arm above generic
            in wire bytes (pod, multipod) and cross-pod bytes
            (multipod), as the JAX package's dry run orders the two
            arms (held on the CPU by tests/test_torch_dryrun.py); the
            reference's report rows, wire and cross-pod bytes a device
            printed; and serving on the model axis, three more processes:
            deepseek-67b prefill_32k and decode_32k on the pod,
            mamba2-2.7b long_500k on the multipod: each ok with its unit
            probes, ``fits_hbm`` the resident bytes against 80 GB, the
            rank's KV bytes (mamba2's cache bytes) the whole's over the
            model axis's 16 and the rows; (b) the dist phase's (b), (d)
            and (e) jobs on 2 fake ranks with their images: bytes a step by label and operation
            and kernel calls a step equal to what the real ranks counted
            in this run, exactly; (c) one step of (b)'s 2-layer
            llama3.2-3b on the card under the counter against its meta
            trace: FLOPs, kernel calls (K2 = 2 x 2, launched) and bytes
            equal (else every operator that took another path printed);
            the train phase's full-width step: the trace's bound beside
            the measured median step, K2 = 8 x 2, the resident estimate
            beside the measured peak, both on the same side of 80 GB

The kernel counters are set to 0 just before each main path is driven
(each pod of the serve phase, each prefill and decode run of the batch
phase, the fig5 calls, each CLI serve, each example, each loopback fleet
of the fabric phase, each CLI training run, (c) of the dist phase, each run of
(d) and (e), each pod of (f) and its one-process reference, the dryrun
phase's real step) and read just
after; a kernel's launches are their sum. K2's and K5's backward kernels
and K4's reverse scan count apart from their forwards (the wrappers'
``bwd_launches``, ``flash_attention_bwd``, ``ssd_bwd`` and
``rglru_scan_bwd`` in the counts and in the kernel records), so every
forward gate keeps its formula and every gate that wants no kernel also
wants no backward; a training step runs K2's backward once per attention
layer (one call, its two to four device kernels), K4's reverse scan once
per rec layer and K5's backward once per ssm layer (one call, its eleven
device kernels). A
torchrun rank starts with its counters at 0 and reports them at exit
(``ranks.json`` in the run's overlay); the dist phase adds them in.
Output ends with a JSON line of kernel records, the card line, and
``{"ok": true, "device": {...}}``.
Without CUDA, or without the port beside this file, it exits non-zero and
prints no result. ``chip_profile.py`` breaks the llama pod's time down by
operator.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("device", "build", "kernels", "fig5", "parity", "serve", "batch",
          "cli", "examples", "fabric", "train", "dist", "dryrun")

# the H100's published peaks (memory rate, operations per second by input
# type), ``bound_ms`` and each kernel's work (``cost()``) live in the port:
# ``repro_torch.launch.analysis`` and ``repro_torch.kernels.*.ops``
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
    # K2's backward kernels (D, dK/dV, dQ from the forward's saved L), the
    # flash-attention Function's backward on a card (the JAX package's
    # backward, ``_bwd_vjp`` at src/repro/kernels/flash_attention/ops.py:60,
    # is the vjp of the plain version: the TPU has no backward kernel)
    "flash_attention_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:98",
    },
    # K5's backward kernels (the chunked algorithm's vjp, from the saved
    # inputs), the SSD Function's backward on a card (the JAX package's
    # backward, ``_bwd_vjp`` at src/repro/kernels/ssd/ops.py:39, is the vjp
    # of the chunked XLA path: the TPU has no backward kernel)
    "ssd_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:89",
    },
    "rglru_scan": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:48",
    },
    # K4's reverse scan: the same kernel run backwards in time, the RG-LRU
    # Function's backward on a card (the JAX package's backward,
    # ``_bwd_vjp`` at src/repro/kernels/rglru_scan/ops.py:40, runs the
    # plain scan on flipped inputs)
    "rglru_scan_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:48",
    },
    "matmul": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul/kernel.py:43",
    },
}

# the scans run in float32 only (as the models call them): K5 within 1e-4 of
# its plain chunked version relative to the output's max (the JAX kernel
# suite's bound), K4 within 1e-5 of its plain sequential version, absolute,
# scaled by max(1, max |h|)
SSD_REL_TOL = 1e-4
RGLRU_TOL = 1e-5
# K3 relative to max |ref|: its FMA chain sums K products in another order
# than the plain version (cuBLAS), so float32 within 1e-4; bfloat16 within
# one bf16 rounding of the float32 sum
MM_REL_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}

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


def _paged_case(torch, rng, *, B, n_kv, g, hd, ps, lengths, dtype, poison,
                mp=None):
    """A shuffled paged layout: live pages scattered over the pool, the
    garbage page 0, spare pages and the tail of each last page poisoned.
    The table is ``mp`` pages wide (default: one more than the longest
    slot needs)."""
    import numpy as np
    mp = mp or max(-(-int(l) // ps) for l in lengths) + 1
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
# and at the llama pod's own decode: 8 slots of 64-544 positions (prompts
# of 64-512 tokens and up to 32 new ones), a table of max_len 1024 / 16
K1_POD_LENGTHS = (64, 544)
K1_POD_MP = 64

# K1 at the other paged pods' decodes, the llama pod's lengths and table:
# stablelm-3b (MHA, 32 heads of 80: g 1), nemotron-4-15b (48 q / 8 kv heads
# of 128: a GQA group of 6 in the 16 MMA rows), moonshot-v1-16b-a3b (MHA,
# 16 heads of 128), musicgen-medium (MHA, 24 heads of 64) and internvl2-2b
# (16 q / 8 kv heads of 128: g 2); the first two also in float32 (the FMA
# kernel), every one timed in bfloat16
K1_PODS = (("stablelm-3b", dict(B=8, n_kv=32, g=1, hd=80, ps=16), True),
           ("nemotron-4-15b", dict(B=8, n_kv=8, g=6, hd=128, ps=16), True),
           ("moonshot-v1-16b-a3b", dict(B=8, n_kv=16, g=1, hd=128, ps=16),
            False),
           ("musicgen-medium", dict(B=8, n_kv=24, g=1, hd=64, ps=16), False),
           ("internvl2-2b", dict(B=8, n_kv=8, g=2, hd=128, ps=16), False))

# K2 (Hq, Hkv, d, Sq, Sk, window): llama3.2-3b's 512-token prefill (the
# kernel's record) and a suffix prefill over a 200-token prefix, then
# recurrentgemma-2b's local-attention prefill past its 2048 window, then
# stablelm-3b's prefill and suffix prefill (head dim 80), nemotron-4-15b's
# 512-token prefill (Hq 48 over Hkv 8) and musicgen-medium's widest packed
# prefill (a 64-row frontend ahead of a 512-token bucket: 576 rows, 24
# heads of 64)
K2_CASES = ((24, 8, 128, 512, 512, 0), (24, 8, 128, 128, 328, 0),
            (10, 1, 256, 2304, 2304, 2048), (32, 32, 80, 512, 512, 0),
            (32, 32, 80, 128, 328, 0), (48, 8, 128, 512, 512, 0),
            (24, 24, 64, 576, 576, 0))
# K2 (B, Hq, Hkv, d, Sq, Sk, window) at the batch phase's whole-batch
# prefills (8 prompts of 512 tokens, f32 and bf16): llama3.2-3b, then
# recurrentgemma-2b's local attention (window 2048, wider than the prompt)
K2_BATCH = ((8, 24, 8, 128, 512, 512, 0), (8, 10, 1, 256, 512, 512, 2048))
# K2 (B, Hq, Hkv, d, Sq, Sk, window, dtype) at the examples phase's calls,
# each in its example's compute dtype, untimed: quickstart and
# hpc_migration (llama3.2-3b-smoke, 8 x 64 tokens, float32), serve_batched
# (6 heads over 2 of 64; one 32-token and seven 64-token prefills, bfloat16)
# and train_100m (8 heads over 4 of 64, 4 x 128 tokens, bfloat16). The
# examples phase fails on a K2 call at a shape not in this list.
K2_EXAMPLES = ((8, 4, 2, 16, 64, 64, 0, "float32"),
               (1, 6, 2, 64, 32, 32, 0, "bfloat16"),
               (1, 6, 2, 64, 64, 64, 0, "bfloat16"),
               (4, 8, 4, 64, 128, 128, 0, "bfloat16"))
# K2 at the dist phase's (d) tensor-parallel ranks: the (1, 2) mesh's
# global batch of 2 x 2048 tokens on each rank, bf16, llama3.2-3b at 12 of
# 24 q heads over 4 of 8 kv heads, moonshot-v1-16b-a3b at 8 of 16 over 8
# of 16 and recurrentgemma-2b's local attention (window 2048) at 5 of 10
# over its 1 kv head (replicated to 2, one a rank). Phases (d) and (e)
# fail on a K2 call at a shape not here.
K2_TP = ((2, 12, 4, 128, 2048, 2048, 0, "bfloat16"),
         (2, 8, 8, 128, 2048, 2048, 0, "bfloat16"),
         (2, 5, 1, 256, 2048, 2048, 2048, "bfloat16"))
# K2 at the dist phase's (e) FSDP ranks: one 2048-token row of
# llama3.2-3b a rank, all 24 q heads over 8 kv heads (params gathered
# whole), bf16. The (d) and (e) shapes are timed, with their bound.
K2_FSDP = ((1, 24, 8, 128, 2048, 2048, 0, "bfloat16"),)
# K2 at the dist phase's (g) PowerSGD ranks: (d)'s llama3.2-3b rank shape
# in float32 compute (the FMA kernel); (g) fails on a K2 call not here
K2_G = ((2, 12, 4, 128, 2048, 2048, 0, "float32"),)
# K1 (B, n_kv, g, hd, ps, mp, dtype) at the dist phase's (f) ranks: the
# llama3.2-3b pod's 8 slots, 12 of 24 q heads over 4 of 8 kv heads a rank,
# its table of 1024 / 16 pages, float32 (the FMA kernel); (f) fails on a K1
# call not here. Its K2, K4 and K5 shapes follow from its requests
# (``_pod_tp_shapes``).
K1_TP = ((8, 4, 3, 128, 16, K1_POD_MP, "float32"),)
# K1 at the dist phase's (i) ranks: a (data 2, model 1) mesh, each rank
# decoding its 4 of the llama3.2-3b pod's 8 slots over all 24 q / 8 kv
# heads, the same table, float32; (i) fails on a K1 call not here
K1_DP = ((4, 8, 3, 128, 16, K1_POD_MP, "float32"),)
# K2 at the dist phase's (h) ranks: moonshot-v1-16b-a3b's attention on
# one 2048-token row a rank of a (data 2, model 1) mesh, 16 over 16 heads
# of 128, bf16; (h) fails on a K2 call not here
K2_DP = ((1, 16, 16, 128, 2048, 2048, 0, "bfloat16"),)
# K2's backward (B, Hq, Hkv, d, Sq, Sk, window, dtype) at every training
# call of the script, held in the kernels phase to the dense float32 plain
# backward (``_kernels_flash_bwd``): llama3.2-3b's full batch (train (a)
# and (c), dist (a)'s rank, (d)'s one process, dryrun (c)), train (a)'s
# recurrentgemma-2b local layers, (d)'s one-process moonshot-v1-16b-a3b
# and recurrentgemma-2b, (g)'s one process (float32), train (b)'s smoke
# steps (float32: llama3.2-3b, moonshot and musicgen at 4/2 heads of 16,
# recurrentgemma at 4/1, window 16), the training examples (quickstart and
# hpc_migration, train_100m), then the ranks' shapes (timed: (d), (e) --
# also (b)'s ranks and its two-microbatch process --, (g), (h)). A phase,
# or a rank, that runs the backward at a shape not here fails.
K2_BWD = ((2, 24, 8, 128, 2048, 2048, 0, "bfloat16"),
          (1, 10, 1, 256, 2048, 2048, 2048, "bfloat16"),
          (2, 16, 16, 128, 2048, 2048, 0, "bfloat16"),
          (2, 10, 1, 256, 2048, 2048, 2048, "bfloat16"),
          (2, 24, 8, 128, 2048, 2048, 0, "float32"),
          (4, 4, 2, 16, 64, 64, 0, "float32"),
          (4, 4, 1, 16, 64, 64, 16, "float32"),
          K2_EXAMPLES[0], K2_EXAMPLES[3])
K2_BWD_RANKS = (*K2_TP, *K2_FSDP, *K2_G, *K2_DP)
# the backward kernels against the dense float32 plain backward, relative
# to its largest gradient: float32 as the forward's FMA kernel; bfloat16
# rounds P and dS before their products (as the forward rounds P before
# P V), 2^-7
K2_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# the head dims whose bfloat16 backward must run the TMA + wgmma kernels:
# a call at one of them that the .cu's route getter
# (``ops.bwd_route``) sends elsewhere fails the run
K2_BWD_WGMMA_DIMS = (64, 128)


def k2_bwd_route(torch, dname: str, d: int) -> tuple[str, bool]:
    """The backward's route at (dtype, d), as the .cu chooses it, and
    whether it is the one this script requires."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    route = fa_ops.bwd_route(getattr(torch, dname), d)
    return route, (route == "wgmma" or dname != "bfloat16"
                   or d not in K2_BWD_WGMMA_DIMS)


def k2_bound(B, Hq, Hkv, d, Sq, Sk, window, isz, dtype):
    """K2's bound from its ``cost()``: q, k, v read and out written once,
    and 4 flops a (q, k) pair inside the causal window per head dim."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.analysis import bound_ms
    flops, nbytes = fa_ops.cost(B, Hq, Hkv, Sq, Sk, d, isz, window=window)
    return bound_ms(nbytes, flops, dtype)


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


def k1_pod_case(torch, shape=K1_SHAPE, dtype=None):
    """K1's inputs at the llama pod's decode (fixed seeds; bfloat16 unless
    ``dtype``), with the heads of ``shape``."""
    import numpy as np
    lo, hi = K1_POD_LENGTHS
    lengths = np.random.default_rng(6).integers(
        lo, hi + 1, shape["B"]).astype(np.int32)
    args = _paged_case(torch, np.random.default_rng(7), lengths=lengths,
                       dtype=dtype or torch.bfloat16, poison=True,
                       mp=K1_POD_MP, **shape)
    return args, lengths


def k1_bound(args, lengths, dtype):
    """K1's bound from its ``cost()`` at these inputs and lengths: live K+V
    pages, q and out, table and lengths moved once; 4 flops a live
    position per head dim. Returns (ms, by, bytes)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.analysis import bound_ms
    q, kp, table = args[0], args[1], args[3]
    n_kv, _, ps, hd = kp.shape
    flops, nbytes = pa_ops.cost(q.shape[0], q.shape[1], n_kv, hd, ps,
                                table.shape[1], [int(n) for n in lengths],
                                q.element_size())
    return (*bound_ms(nbytes, flops, dtype), nbytes)


def phase_kernels(torch, state, timer) -> None:
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels._launch import device_sms
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
                bms, by, nbytes = k1_bound(args, lengths, dname)
                records["paged_attention"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)
                kernel = pa_ops.kernel_choice(dt, g, hd)[0]
                span = pa_ops.span_pages(B, n_kv, args[3].shape[1], ps,
                                         device_sms(out.device))
                log(f"kernels: paged_attention bf16 time {ms:.4f} ms (kernel "
                    f"{kernel}, span {span} pages), plain {plain:.4f} ms, "
                    f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB live), "
                    f"library none [{state['card']}]")
                # the FMA kernel on the same plan (counted, and reset before
                # the main paths): what the tensor cores and the page ring
                # add beyond the span plan
                fma_ms = timer(lambda: pa_ops.paged_attention_cuda(
                    *args, kernel="fma"))
                log(f"kernels: paged_attention bf16 fma kernel, same spans: "
                    f"{fma_ms:.4f} ms (not chosen) [{state['card']}]")

    # K1 at the llama pod's own decode (bf16, window 0)
    args, lengths = k1_pod_case(torch)
    out = pa_ops.paged_attention_cuda(*args)
    ref = paged_attention_ref(*args)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    ok = bool(torch.isfinite(out).all()) and err <= TOL["bfloat16"]
    ms = timer(lambda: pa_ops.paged_attention_cuda(*args))
    bms, by, nbytes = k1_bound(args, lengths, "bfloat16")
    log(f"kernels: paged_attention at the llama pod's decode (B={B}, lengths "
        f"{sorted(int(n) for n in lengths)}, mp={K1_POD_MP}) bfloat16: "
        f"max_abs_err {err:.3e} (tol {TOL['bfloat16']:g}) "
        f"{'ok' if ok else 'FAIL'}; time {ms:.4f} ms, bound {bms:.4f} ms "
        f"({by}: {nbytes / 1e6:.2f} MB) [{state['card']}]")
    if not ok:
        failures.append("paged_attention at the pod's decode")

    # K1 at the other paged pods' decodes (bf16 on the tensor cores, f32 on
    # the FMA kernel), timed in bf16
    for arch, shape, with_f32 in K1_PODS:
        sb, skv, sg, shd, sps = (shape[k]
                                 for k in ("B", "n_kv", "g", "hd", "ps"))
        for dname, dt in dts.items():
            if dname == "float32" and not with_f32:
                continue
            args, lengths = k1_pod_case(torch, shape, dt)
            out = pa_ops.paged_attention_cuda(*args)
            ref = paged_attention_ref(*args)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            ok = bool(torch.isfinite(out).all()) and err <= TOL[dname]
            line = (f"kernels: paged_attention at {arch}'s pod decode "
                    f"(B={sb} n_kv={skv} g={sg} hd={shd} ps={sps}, kernel "
                    f"{pa_ops.kernel_choice(dt, sg, shd)[0]}) {dname}: "
                    f"max_abs_err {err:.3e} (tol {TOL[dname]:g}) "
                    f"{'ok' if ok else 'FAIL'}")
            if dname == "bfloat16":
                ms = timer(lambda: pa_ops.paged_attention_cuda(*args))
                plain = timer(lambda: paged_attention_ref(*args))
                bms, by, nbytes = k1_bound(args, lengths, dname)
                line += (f"; time {ms:.4f} ms, plain {plain:.4f} ms, bound "
                         f"{bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB), "
                         f"library none [{state['card']}]")
            log(line)
            if not ok:
                failures.append(f"paged_attention {arch} {dname}")

    # K1 at (f)'s per-rank decode: llama3.2-3b's 12 q heads over 4 kv heads
    # a rank of the model axis, float32 (the FMA kernel), the pod's table;
    # and at (i)'s: 4 of the 8 slots a rank of the data axis, every head
    checked = state["k1_checked"] = set()
    for case in K1_TP + K1_DP:
        sb, skv, sg, shd, sps, smp, dname = case
        shape = dict(B=sb, n_kv=skv, g=sg, hd=shd, ps=sps)
        args, lengths = k1_pod_case(torch, shape, dts[dname])
        check(args[3].shape[1] == smp, f"K1 case table {args[3].shape}")
        out = pa_ops.paged_attention_cuda(*args)
        ref = paged_attention_ref(*args)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ok = bool(torch.isfinite(out).all()) and err <= TOL[dname]
        ms = timer(lambda: pa_ops.paged_attention_cuda(*args))
        bms, by, nbytes = k1_bound(args, lengths, dname)
        state.setdefault("kernel_dist", {})[
            f"K1 {sb}x{skv * sg}/{skv}x{shd} mp{smp} {dname}"] = dict(
            ms=ms, bound_ms=bms, bound_by=by, max_abs_err=err)
        log(f"kernels: paged_attention at a dist rank's decode (B={sb} "
            f"n_kv={skv} g={sg} hd={shd} ps={sps} mp={smp}, kernel "
            f"{pa_ops.kernel_choice(dts[dname], sg, shd)[0]}) {dname}: "
            f"max_abs_err {err:.3e} (tol {TOL[dname]:g}) "
            f"{'ok' if ok else 'FAIL'}; time {ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}: {nbytes / 1e6:.2f} MB) [{state['card']}]")
        if ok:
            checked.add(case)
        else:
            failures.append(f"paged_attention dist {case}")

    # -- K2: llama3.2-3b prefill and suffix prefill; recurrentgemma-2b's
    # local-attention prefill of 2304 tokens, window 2048 (query tiles past
    # the window start their key loop late) -----------------------------
    cases = ([((1, *c), tuple(dts), True) for c in K2_CASES]
             + [(c, tuple(dts), True) for c in K2_BATCH]
             + [(c[:-1], c[-1:], False) for c in K2_EXAMPLES]
             + [(c[:-1], c[-1:], "dist") for c in
                (*K2_TP, *K2_FSDP, *K2_G, *K2_DP,
                 *_pod_tp_shapes()["k2"])])
    checked = state["k2_checked"] = set()
    for (Bq, Hq, Hkv, d, Sq, Sk, window), dnames, timed in cases:
        for dname in dnames:
            dt = dts[dname]
            r = np.random.default_rng(2)
            q = torch.from_numpy(r.standard_normal((Bq, Hq, Sq, d)).astype(
                np.float32)).to("cuda", dt)
            k = torch.from_numpy(r.standard_normal((Bq, Hkv, Sk, d)).astype(
                np.float32)).to("cuda", dt)
            v = torch.from_numpy(r.standard_normal((Bq, Hkv, Sk, d)).astype(
                np.float32)).to("cuda", dt)
            out = fa_ops.flash_attention_fwd_cuda(q, k, v, causal=True,
                                                  window=window)
            ref = flash_attention_ref(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            finite = bool(torch.isfinite(out).all())
            ok = finite and err <= TOL[dname]
            kind = "tensor cores" if dname == "bfloat16" else "fma"
            log(f"kernels: flash_attention_fwd B={Bq} Hq={Hq} Hkv={Hkv} d={d} "
                f"Sq={Sq} Sk={Sk} causal window={window} {dname} ({kind}): "
                f"max_abs_err {err:.3e} (tol {TOL[dname]:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash_attention_fwd {dname} B={Bq} d={d} "
                                f"Sq={Sq} Sk={Sk} window={window}")
            checked.add((Bq, Hq, Hkv, d, Sq, Sk, window, dname))
            del ref
            if timed == "dist":
                ms = timer(lambda: fa_ops.flash_attention_fwd_cuda(
                    q, k, v, causal=True, window=window))
                bms, by = k2_bound(Bq, Hq, Hkv, d, Sq, Sk, window,
                                   out.element_size(), dname)
                over = f"/{Sk}" if Sk != Sq else ""
                state.setdefault("kernel_dist", {})[
                    f"K2 {Bq}x{Hq}/{Hkv}x{Sq}{over}x{d} w{window} "
                    f"{dname}"] = dict(ms=ms, bound_ms=bms, bound_by=by,
                                       max_abs_err=err)
                log(f"kernels: flash_attention_fwd at a dist rank's shape "
                    f"B={Bq} Hq={Hq} Hkv={Hkv} d={d} Sq={Sq} Sk={Sk} "
                    f"window={window} {dname}: time {ms:.4f} ms, bound "
                    f"{bms:.4f} ms ({by}) [{state['card']}]")
                continue
            if not timed or Sq != Sk or dname != "bfloat16" or Bq > 1:
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
            bms, by = k2_bound(Bq, Hq, Hkv, d, Sq, Sk, window,
                               out.element_size(), dname)
            if "flash_attention_fwd" not in records:
                records["flash_attention_fwd"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib)
            lib_txt = (f"library (scaled_dot_product_attention"
                       f"{', boolean mask' if window else ''}) {lib:.4f} ms")
            log(f"kernels: flash_attention_fwd Hq={Hq} d={d} S={Sq} "
                f"window={window} bf16 time {ms:.4f} ms, plain {plain:.4f} "
                f"ms, bound {bms:.4f} ms ({by}), {lib_txt} [{state['card']}]")

    failures += _kernels_flash_bwd(torch, state, timer)
    failures += _kernels_ssd(torch, state, timer)
    failures += _kernels_ssd_bwd(torch, state, timer)
    failures += _kernels_rglru(torch, state, timer)
    failures += _kernels_matmul(torch, state, timer)
    check(not failures, "kernel mismatches: " + "; ".join(failures))


def _k2_key(q, k, window, causal) -> tuple:
    """A K2 call's shape as the gates compare it: (B, Hq, Hkv, d, Sq, Sk,
    window, dtype, causal)."""
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[3], q.shape[2],
            k.shape[2], int(window), str(q.dtype).removeprefix("torch."),
            bool(causal))


def _kernels_flash_bwd(torch, state, timer) -> list[str]:
    """K2's backward kernels at every K2_BWD and K2_BWD_RANKS shape, from
    the forward kernel's out and L, against the dense float32 plain
    backward fed the float32 plain out and L on the same inputs: dq, dk
    and dv within K2_BWD_TOL of its largest gradient, on the route that
    ``k2_bwd_route`` requires; the ranks' shapes timed beside their bound
    and SDPA's backward. Keeps the shapes held in
    ``state["k2_bwd_checked"]``."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref,
        flash_attention_ref)
    failures = []
    checked = state["k2_bwd_checked"] = set()
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for case in (*K2_BWD, *K2_BWD_RANKS):
        B, Hq, Hkv, d, Sq, Sk, window, dname = case
        r = np.random.default_rng(3)
        q, k, v, dout = (torch.from_numpy(r.standard_normal(shape).astype(
            np.float32)).to("cuda", dts[dname]) for shape in (
            (B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d), (B, Hq, Sq, d)))
        kw = dict(causal=True, window=window)
        out, lse = fa_ops.flash_attention_fwd_cuda(q, k, v, lse=True, **kw)
        got = fa_ops.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        f = [t.float() for t in (q, k, v)]
        want = flash_attention_bwd_ref(
            *f, flash_attention_ref(*f, **kw),
            flash_attention_lse_ref(*f[:2], **kw), dout.float(), **kw)
        torch.cuda.synchronize()
        errs = [float((a.float() - b).abs().max()) for a, b in zip(got, want)]
        lims = [K2_BWD_TOL[dname] * float(b.abs().max()) for b in want]
        route, route_ok = k2_bwd_route(torch, dname, d)
        ok = (route_ok and all(bool(torch.isfinite(a).all()) for a in got)
              and all(e <= lim for e, lim in zip(errs, lims)))
        del got, want, f
        held = ", ".join(f"{e:.2e}/{lim:.2e}" for e, lim in zip(errs, lims))
        line = (f"kernels: flash_attention_bwd B={B} Hq={Hq} Hkv={Hkv} d={d} "
                f"Sq={Sq} Sk={Sk} causal window={window} {dname} (route "
                f"{route}{'' if route_ok else ', not the required wgmma'}): "
                f"dq, dk, dv max_abs_err vs the dense float32 plain backward "
                f"(err/tol) {held} {'ok' if ok else 'FAIL'}")
        if case in K2_BWD_RANKS:
            ms = timer(lambda: fa_ops.flash_attention_bwd_cuda(
                q, k, v, out, lse, dout, **kw))
            bms, by = k2_bwd_bound(B, Hq, Hkv, d, Sq, Sk, window,
                                   q.element_size(), dname)
            rec = dict(ms=ms, bound_ms=bms, bound_by=by,
                       max_abs_err=max(errs))
            line += f"; time {ms:.4f} ms, bound {bms:.4f} ms ({by})"
            # the library's attention backward on the same inputs (an
            # explicit mask where the window cuts into the keys)
            xs = [t.detach().requires_grad_() for t in (
                q, k.repeat_interleave(Hq // Hkv, dim=1),
                v.repeat_interleave(Hq // Hkv, dim=1))]
            mask = None
            if window and window < Sk:
                rows = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
                cols = torch.arange(Sk, device="cuda")[None, :]
                mask = (cols <= rows) & (cols > rows - window)
            o = F.scaled_dot_product_attention(
                *xs, attn_mask=mask, is_causal=mask is None)
            rec["library_ms"] = timer(lambda: torch.autograd.grad(
                o, xs, dout, retain_graph=True))
            line += (f", library (scaled_dot_product_attention "
                     f"backward) {rec['library_ms']:.4f} ms")
            del xs, o, mask
            state.setdefault("kernel_dist", {})[
                f"K2 backward {B}x{Hq}/{Hkv}x{Sq}x{d} w{window} "
                f"{dname}"] = rec
            line += f" [{state['card']}]"
        log(line)
        if ok:
            checked.add((*case, True))
        else:
            failures.append(f"flash_attention_bwd {case}")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return failures


# K5 at mamba2-2.7b's prefill (a 512-token prompt: two 256-step chunks; the
# kernel's record), a ragged batch of two 192-token prompts (one chunk of
# 192 steps, not a multiple of the kernel's 64-row tiles), then the mamba2
# pod's shortest and longest prefills (64 tokens: one 64-step chunk; 768:
# three chunks), timed beside the record; then the batch phase's
# whole-batch prefill (8 prompts of 512 tokens)
K5_CASES = ((1, 512, 80, 64, 128, 256), (2, 192, 80, 64, 128, 192),
            (1, 64, 80, 64, 128, 64), (1, 768, 80, 64, 128, 256),
            (8, 512, 80, 64, 128, 256), (2, 2048, 40, 64, 128, 256))
K5_POD = K5_CASES[2:4]
# K5 at the dist phase's (d) mamba2-2.7b ranks: both 2048-token rows, 40
# of 80 heads a rank (B and C whole); (d) fails on a K5 call not here
K5_TP = K5_CASES[5:]


def _kernels_ssd(torch, state, timer) -> list[str]:
    import numpy as np
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import _ssd_chunked
    from repro_torch.launch.analysis import bound_ms

    failures = []
    pod = tuple(c for c in _pod_tp_shapes()["k5"] if c not in K5_CASES)
    for case in K5_CASES + pod:
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
        if case != K5_CASES[0] and case not in K5_POD + K5_TP + pod:
            continue
        ms = timer(lambda: ssd_ops.ssd_cuda(x, dt, A, B, C, Q))
        flops, nbytes = ssd_ops.cost(b, S, H, P, N, Q)
        bms, by = bound_ms(nbytes, flops, "float32")
        # the bound of the arithmetic the kernel runs: three TF32 products
        # for each float32 one, on the tensor cores
        tc_ms, tc_by = bound_ms(nbytes, 3 * flops, "tf32")
        if case in K5_POD + K5_TP + pod:
            where = ("the mamba2 pod's prefill" if case in K5_POD
                     else f"a (d) or (f) rank's b={b} H={H}")
            log(f"kernels: ssd at {where} S={S} chunk={Q}: "
                f"{ms:.4f} ms, bound {bms:.4f} ms (f32 FMA), {tc_ms:.4f} ms "
                f"(3xTF32 {tc_by}) [{state['card']}]")
            if case in K5_TP + pod:
                state.setdefault("kernel_dist", {})[
                    "K5 {}x{}x{}x{}x{} c{}".format(*case)] = dict(
                    ms=ms, bound_ms=bms, bound_by=by, tc_bound_ms=tc_ms,
                    max_abs_err=err_y)
            continue
        plain = timer(lambda: _ssd_chunked(x, dt, A, B, C, Q))
        state["records"]["ssd"] = dict(
            max_abs_err=err_y, ms=ms, plain_ms=plain, bound_ms=bms,
            bound_by=by, library_ms=None)
        log(f"kernels: ssd float32 time {ms:.4f} ms (3xTF32 tensor cores, "
            f"P slice {ssd_ops.p_tile(P)}), plain {plain:.4f} ms, bound "
            f"{bms:.4f} ms ({by}, f32 FMA: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP), 3xTF32 bound {tc_ms:.4f} ms "
            f"({tc_by}: {3 * flops / 1e9:.3f} GFLOP at the TF32 rate), "
            f"library none [{state['card']}]")
    return failures


def _kernels_ssd_bwd(torch, state, timer) -> list[str]:
    """K5's backward kernels at the train phase's shape GRAD_K5 (the
    kernel's record) and at (d)'s mamba2-2.7b ranks' (K5_TP: 40 of 80
    heads, both 2048-token rows), no gradient reaching the final state
    (as training): every grad within SSD_REL_TOL of the largest of
    the plain backward ``ssd_bwd_ref`` on the same inputs, the same bits
    from two calls; times beside ``cost_bwd``'s bound and the plain
    backward's."""
    import numpy as np
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_bwd_ref
    from repro_torch.launch.analysis import bound_ms

    failures = []
    record = (*GRAD_K5[0], GRAD_K5[1])
    for case in (record, *K5_TP):
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
        got = ssd_ops.ssd_bwd_cuda(x, dt, A, B, C, Q, gy)
        again = ssd_ops.ssd_bwd_cuda(x, dt, A, B, C, Q, gy)
        want = ssd_bwd_ref(x, dt, A, B, C, Q, gy)
        torch.cuda.synchronize()
        errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
        lims = [SSD_REL_TOL * float(w.abs().max()) for w in want]
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        ok = (same and all(bool(torch.isfinite(a).all()) for a in got)
              and all(e <= lim for e, lim in zip(errs, lims)))
        del got, again, want
        ms = timer(lambda: ssd_ops.ssd_bwd_cuda(x, dt, A, B, C, Q, gy))
        plain = timer(lambda: ssd_bwd_ref(x, dt, A, B, C, Q, gy))
        flops, nbytes = ssd_ops.cost_bwd(b, S, H, P, N, Q)
        bms, by = bound_ms(nbytes, flops, "float32")
        held = ", ".join(f"{n} {e:.2e}/{lim:.2e}" for n, e, lim in zip(
            ("dx", "ddt", "dA", "dB", "dC"), errs, lims))
        log(f"kernels: ssd_bwd b={b} S={S} H={H} P={P} N={N} chunk={Q} "
            f"float32: grads vs the plain backward (err/tol) {held}; a "
            f"second call {'bit-identical' if same else 'DIFFERS'} "
            f"{'ok' if ok else 'FAIL'}; time {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bms:.4f} ms ({by}, f32 FMA: "
            f"{flops / 1e9:.3f} GFLOP), library none [{state['card']}]")
        if not ok:
            failures.append(f"ssd_bwd {case}")
        if case == record:
            state["records"]["ssd_bwd"] = dict(
                max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)
        else:
            state.setdefault("kernel_dist", {})[
                "K5 backward {}x{}x{}x{}x{} c{}".format(*case)] = dict(
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                max_abs_err=max(errs))
        del x, dt, A, B, C, gy
        torch.cuda.empty_cache()
    return failures


# K4 at recurrentgemma-2b's prefill widths: one 2304-token prompt (the
# kernel's record), a ragged batch of three 100-token prompts, then the
# recurrentgemma pod's shorter prefills (64 and 512 tokens), timed beside
# the record; then the batch phase's whole-batch prefill (8 x 512 tokens)
K4_CASES = ((1, 2304, 2560), (3, 100, 2560), (1, 64, 2560), (1, 512, 2560),
            (8, 512, 2560), (2, 2048, 1280))
# K4 at the dist phase's (d) recurrentgemma-2b ranks: both 2048-token
# rows, 1280 of 2560 channels a rank; (d) fails on a K4 call not here
K4_TP = K4_CASES[5:]
K4_TIMED = (K4_CASES[0], K4_CASES[2], K4_CASES[3], *K4_TP)


def _kernels_rglru(torch, state, timer) -> list[str]:
    import numpy as np
    from repro_torch.kernels._launch import device_sms
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.launch.analysis import bound_ms

    failures = []
    pod = tuple(c for c in _pod_tp_shapes()["k4"] if c not in K4_CASES)
    for case in K4_CASES + pod:
        rng = np.random.default_rng(4)
        a = torch.from_numpy((1.0 / (1.0 + np.exp(-rng.standard_normal(
            case)))).astype(np.float32)).to("cuda")
        b = torch.from_numpy(rng.standard_normal(case).astype(
            np.float32)).to("cuda")
        ref = rglru_scan_ref(a, b)
        tol = RGLRU_TOL * max(1.0, float(ref.abs().max()))
        plan = rg_ops.scan_plan(*case, device_sms(a.device))
        # the look-back composes in a fixed order: repeated calls agree
        # bit for bit
        h, again = rg_ops.rglru_scan_cuda(a, b), rg_ops.rglru_scan_cuda(a, b)
        torch.cuda.synchronize()
        err = float((h - ref).abs().max())
        same = bool(torch.equal(h, again))
        ok = bool(torch.isfinite(h).all()) and err <= tol and same
        if not ok:
            failures.append(f"rglru_scan {case}")
        # the reverse scan (the backward's dh from a and the cotangent b)
        # at the same shape against the plain scan on flipped copies
        def plain_rev():
            a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
            return rglru_scan_ref(a_next.flip(1), b.flip(1)).flip(1)
        ref_rev = plain_rev()
        rtol = RGLRU_TOL * max(1.0, float(ref_rev.abs().max()))
        dh = rg_ops.rglru_scan_cuda(a, b, reverse=True)
        dh_again = rg_ops.rglru_scan_cuda(a, b, reverse=True)
        torch.cuda.synchronize()
        rerr = float((dh - ref_rev).abs().max())
        rsame = bool(torch.equal(dh, dh_again))
        rok = bool(torch.isfinite(dh).all()) and rerr <= rtol and rsame
        log(f"kernels: rglru_scan reverse B={case[0]} S={case[1]} "
            f"R={case[2]} float32: max_abs_err {rerr:.3e} against the plain "
            f"reverse scan (tol {rtol:.3e}); a second call "
            f"{'bit-identical' if rsame else 'DIFFERS'} "
            f"{'ok' if rok else 'FAIL'}")
        if not rok:
            failures.append(f"rglru_scan reverse {case}")
        del dh, dh_again
        tile = (f"tile 32 x {plan.T} ({plan.steps} steps a warp), "
                f"{plan.n_tiles} tiles; a second call "
                f"{'bit-identical' if same else 'DIFFERS'}")
        if case not in K4_TIMED + pod:
            log(f"kernels: rglru_scan B={case[0]} S={case[1]} R={case[2]} "
                f"float32 ({tile}): max_abs_err {err:.3e} against the "
                f"sequential version (tol {tol:.3e}) "
                f"{'ok' if ok else 'FAIL'}")
            continue
        ms = timer(lambda: rg_ops.rglru_scan_cuda(a, b))
        flops, nbytes = rg_ops.cost(*case)
        bms, by = bound_ms(nbytes, flops, "float32")
        log(f"kernels: rglru_scan B={case[0]} S={case[1]} R={case[2]} "
            f"float32 ({tile}): max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}; time {ms:.4f} ms, bound {bms:.4f} "
            f"ms ({by}: {nbytes / 1e6:.2f} MB) [{state['card']}]")
        if case in K4_TP + pod:
            state.setdefault("kernel_dist", {})[
                "K4 {}x{}x{}".format(*case)] = dict(
                ms=ms, bound_ms=bms, bound_by=by, max_abs_err=err)
        if case != K4_CASES[0]:
            continue
        plain = timer(lambda: rglru_scan_ref(a, b))
        state["records"]["rglru_scan"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
            bound_by=by, library_ms=None)
        log(f"kernels: rglru_scan float32 time {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bms:.4f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB), library none; scratch zero-fills so "
            f"far {rg_ops.scratch_fills} [{state['card']}]")
        # the reverse scan moves the same bytes: the forward's bound
        rms = timer(lambda: rg_ops.rglru_scan_cuda(a, b, reverse=True))
        rplain = timer(plain_rev)
        state["records"]["rglru_scan_bwd"] = dict(
            max_abs_err=rerr, ms=rms, plain_ms=rplain, bound_ms=bms,
            bound_by=by, library_ms=None)
        log(f"kernels: rglru_scan reverse float32 time {rms:.4f} ms, plain "
            f"(on flipped copies) {rplain:.4f} ms, bound {bms:.4f} ms "
            f"({by}), library none [{state['card']}]")
    return failures


# K3 (M, K, N, dtype): tests/test_kernels.py:159's MM_CASES, a ragged shape
# no block divides (N 300: the FMA kernel in bf16 too), a ragged M with K
# and N multiples of 8 (TMA's zero-filled edges on the tensor cores), then
# llama3.2-3b's prefill MLP products for a 512-token prompt (gate/up, then
# down; the kernel's record is the first bf16 one)
K3_CASES = ((256, 256, 256, "float32"), (128, 384, 256, "bfloat16"),
            (64, 64, 64, "float32"), (512, 128, 256, "bfloat16"),
            (100, 200, 300, "bfloat16"), (100, 200, 304, "bfloat16"))
K3_LLAMA = ((512, 3072, 8192), (512, 8192, 3072))


def _mm_inputs(torch, M, K, N, dt, device="cuda"):
    import numpy as np
    rng = np.random.default_rng(5)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    return (torch.from_numpy(a).to(device, dt),
            torch.from_numpy(b).to(device, dt))


def _kernels_matmul(torch, state, timer) -> list[str]:
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.launch.analysis import bound_ms

    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = list(K3_CASES) + [(M, K, N, d) for M, K, N in K3_LLAMA
                              for d in ("bfloat16", "float32")]
    failures = []
    for M, K, N, dname in cases:
        a, b = _mm_inputs(torch, M, K, N, dts[dname])
        blocks = mm_ops.blocks(M, N, K, "h100")
        kernel, bm, bn = mm_ops.kernel_choice(M, N, K, dts[dname])
        out = mm_ops.matmul_cuda(a, b)
        ref = matmul_ref(a, b)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = MM_REL_TOL[dname] * float(ref.float().abs().max())
        ok = bool(torch.isfinite(out).all()) and err <= tol
        log(f"kernels: matmul M={M} K={K} N={N} {dname} (kernel {kernel}, "
            f"tile {bm} x {bn}, {-(-M // bm) * -(-N // bn)} blocks; JAX "
            f"wrapper's blocks {blocks}): max_abs_err {err:.3e} "
            f"(tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"matmul {(M, K, N, dname)}")
        ms = timer(lambda: mm_ops.matmul_cuda(a, b))
        plain = timer(lambda: matmul_ref(a, b))
        lib = timer(lambda: torch.matmul(a, b))
        flops, nbytes = mm_ops.cost(M, N, K, a.element_size())
        bms, by = bound_ms(nbytes, flops, dname)
        if "matmul" not in state["records"] and (M, K, N) in K3_LLAMA:
            state["records"]["matmul"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)
        log(f"kernels: matmul M={M} K={K} N={N} {dname} time {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, bound "
            f"{bms:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), library (torch.matmul) {lib:.4f} ms "
            f"[{state['card']}]")
        if (M, K, N) not in K3_LLAMA:
            continue
        # the kernel's other tile at this shape (its launches count, and
        # are reset before the main paths): the evidence for
        # kernel_choice's MIN_BLOCKS
        for tile in mm_ops.TILES[kernel]:
            if tile == (bm, bn):
                continue
            alt = mm_ops.launch_tile(a, b, kernel, *tile)
            torch.cuda.synchronize()
            alt_err = float((alt.float() - ref.float()).abs().max())
            alt_ms = timer(lambda: mm_ops.launch_tile(a, b, kernel, *tile))
            log(f"kernels: matmul M={M} K={K} N={N} {dname} {kernel} tile "
                f"{tile[0]} x {tile[1]} "
                f"({-(-M // tile[0]) * -(-N // tile[1])} blocks, not chosen): "
                f"{alt_ms:.4f} ms, max_abs_err {alt_err:.3e} "
                f"[{state['card']}]")
            if not alt_err <= tol:
                failures.append(f"matmul {(M, K, N, dname)} tile {tile}")
    return failures


def _host_us(torch, fn, reps: int) -> float:
    """Host microseconds a call over ``reps`` calls, ended by a device
    synchronise (the fig5 benchmark's timing, with torch for jax)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


# fig5: the benchmark's own shape, then llama3.2-3b's prefill MLP products
FIG5_CASES = ((256, 256, 256, "float32", 50),
              (512, 3072, 8192, "bfloat16", 10),
              (512, 8192, 3072, "bfloat16", 10),
              (512, 3072, 8192, "float32", 10),
              (512, 8192, 3072, "float32", 10))


def phase_fig5(torch, state, workdir: Path) -> None:
    """benchmarks/fig5_tuned_kernel.py on the card: its rows under its
    names (the 256^3 float32 rows first; full-width rows name their
    shape), native and container-bound matmul outputs equal bit for bit."""
    import numpy as np
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul.ref import matmul_ref

    rt = Runtime(workdir / "fig5")
    rt.build(SMOKE_IMAGEFILE.format(arch="llama3.2-3b-smoke"), tag="fig5")
    device = rt.run("fig5").device           # MESH local, resolved here
    check(device.type == "cuda", f"fig5: container bound to {device}")
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    failures = []

    def row(name, val, extra=""):
        log(f"fig5: {name},{val:.1f},{extra}")

    _reset_counts()
    calls = 0
    for M, K, N, dname, reps in FIG5_CASES:
        a, b = _mm_inputs(torch, M, K, N, dts[dname], device)
        native = _host_us(torch, lambda: mm_ops.matmul(
            a, b, platform="h100"), reps)
        container = _host_us(torch, lambda: mm_ops.matmul(a, b), reps)
        out_n = mm_ops.matmul(a, b, platform="h100")
        out_c = mm_ops.matmul(a, b)
        calls += 2 * (reps + 3) + 2
        ref = matmul_ref(a, b)
        torch.cuda.synchronize()
        same = torch.equal(out_n, out_c)
        err = float((out_c.float() - ref.float()).abs().max())
        tol = MM_REL_TOL[dname] * float(ref.float().abs().max())
        shape = ("" if (M, K, N) == (256, 256, 256)
                 else f"M={M} K={K} N={N} {dname} ")
        row("fig5/matmul_native_us", native, shape.strip())
        row("fig5/matmul_container_us", container,
            f"{shape}overhead={(container - native) / native * 100:+.1f}% "
            f"err={err:.1e} native==container bitwise: {same}")
        if not (same and err <= tol):
            failures.append(f"matmul {(M, K, N, dname)}: bitwise {same}, "
                            f"err {err:.3e} (tol {tol:.3e})")

    rng = np.random.default_rng(2)
    t = lambda *s: torch.from_numpy(                            # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    q, k, v = t(1, 4, 128, 64), t(1, 2, 128, 64), t(1, 2, 128, 64)
    t_kernel = _host_us(torch, lambda: fa_ops.flash_attention_fwd_cuda(
        q, k, v, causal=True), 50)
    t_ref = _host_us(torch, lambda: flash_attention_ref(q, k, v, causal=True),
                     50)
    out = fa_ops.flash_attention_fwd_cuda(q, k, v, causal=True)
    err = float((out - flash_attention_ref(q, k, v, causal=True)).abs().max())
    row("fig5/flash_attn_kernel_us", t_kernel, f"K2 on {device}")
    row("fig5/flash_attn_ref_us", t_ref, f"err={err:.1e}")
    row("fig5/block_table_entries", float(len(mm_ops.BLOCK_TABLE)),
        "per-platform run-time binding")
    counts = _main_path_counts(state)
    log(f"fig5: launches {counts} [{state['card']}]")
    if err > TOL["float32"]:
        failures.append(f"flash attention err {err:.3e}")
    check(counts["matmul"] == calls and counts["flash_attention_fwd"] == 54,
          f"fig5: launches {counts}, expected matmul {calls}, "
          "flash_attention_fwd 54")
    check(not failures, "fig5: " + "; ".join(failures))


def _ops_modules() -> dict:
    """Kernel name -> its wrapper module (each keeps ``launches``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"paged_attention": pa_ops, "flash_attention_fwd": fa_ops,
            "ssd": ssd_ops, "rglru_scan": rg_ops, "matmul": mm_ops}


def _launch_counts() -> dict:
    """Kernel name -> launches: each wrapper's forward counter, then the
    backward ones (``rglru_scan_bwd``: K4's reverse scan), so every gate
    that wants a kernel nowhere also wants no backward there."""
    from repro_torch.kernels import bwd_launch_counts
    return {**{name: m.launches for name, m in _ops_modules().items()},
            **bwd_launch_counts()}


def _reset_counts() -> None:
    for m in _ops_modules().values():
        m.launches = 0
        if hasattr(m, "bwd_launches"):
            m.bwd_launches = 0


def _main_path_counts(state) -> dict:
    """The counts since ``_reset_counts``, added to the run's main-path
    launches (a kernel's reported launches sum over its main paths)."""
    counts = _launch_counts()
    for name, n in counts.items():
        state["launches"][name] = state["launches"].get(name, 0) + n
    return counts


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

    def frontend():
        # 4-row frontend buffer (the smoke size): none, partial and full
        # prefixes ahead of 3-20 token prompts
        rng = np.random.default_rng(10)
        out = []
        for i in range(12):
            fl = (0, 1, 2, 4)[i % 4]
            fe = (0.02 * rng.standard_normal((fl, 64)).astype(np.float32)
                  if fl else None)
            out.append(GenRequest(
                rid=i, prompt=rng.integers(0, 256, int(rng.integers(3, 21))),
                max_new_tokens=int(rng.integers(3, 10)), frontend=fe))
        return out

    contiguous = dict(n_slots=3, max_len=64)
    paged_prefix = dict(n_slots=4, max_len=64, paged=True, page_size=8,
                        prefix_cache=True)
    paged = dict(n_slots=4, max_len=64, paged=True, page_size=8)
    attention = ("paged_attention", "flash_attention_fwd")
    return {
        "llama3.2-3b-smoke": (llama, paged_prefix, attention),
        "mamba2-2.7b-smoke": (mamba2, contiguous, ("ssd",)),
        "recurrentgemma-2b-smoke": (recurrentgemma,
                                    dict(n_slots=3, max_len=128),
                                    ("rglru_scan", "flash_attention_fwd")),
        "nemotron-4-15b-smoke": (llama, paged_prefix, attention),
        "moonshot-v1-16b-a3b-smoke": (llama, paged_prefix, attention),
        "musicgen-medium-smoke": (frontend, paged, attention),
        "internvl2-2b-smoke": (frontend, paged, attention),
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
    failures += _parity_static_continuous(workdir)
    check(not failures, "parity: tokens differ: " + "; ".join(failures))


def _parity_static_continuous(workdir: Path) -> list[str]:
    """llama3.2-3b-smoke (f32) served on the card by launch/serve.main in
    continuous and in static mode: the same tokens request for request."""
    from repro_torch.launch.serve import main as serve_main
    argv = ["--image", "llama3.2-3b-smoke", "--root", str(workdir / "smoke"),
            "--replicas", "1", "--slots", "4", "--requests", "12",
            "--prompt-len", "24", "--gen", "12"]
    cont = serve_main(argv)
    static = serve_main(argv + ["--mode", "static"])
    same = static["request_tokens"] == cont["request_tokens"]
    log(f"parity: llama3.2-3b-smoke launch/serve.main on the card, "
        f"{cont['requests']} requests: static vs continuous tokens "
        f"identical: {same}")
    return [] if same and cont["requests"] == 12 else [
        f"static vs continuous\n static {static['request_tokens']}\n "
        f"continuous {cont['request_tokens']}"]


def _drive_pod(torch, state, rt, arch, reqs, expect, watch=None, **kw):
    """Serve ``reqs`` on a fresh full-width pod of ``arch``: counters set to
    0 just before the scheduler runs and read just after. ``expect`` maps
    each kernel of the path to its launches per prefill dispatch
    ("prefill", layers) or per decode step ("decode", layers). ``watch``,
    a context manager, is entered around the scheduler's run only. Returns
    the pod."""
    from contextlib import nullcontext

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
    with watch or nullcontext():
        sched.run(max_ticks=10_000)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _main_path_counts(state)

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

    # logits of the served model: finite, of the expected shape (a
    # frontend arch's with the last request's prefix ahead of its prompt)
    from repro_torch.models.layers import padded_vocab
    c = eng.container
    prompt = torch.as_tensor(reqs[-1].prompt[None], device=c.device)
    fe = reqs[-1].frontend
    fe = (None if fe is None else
          torch.as_tensor(fe[None], device=c.device).to(c.cache_dtype))
    with torch.no_grad():
        logits, _ = c.model.forward(eng.params, prompt, frontend_embeds=fe)
    torch.cuda.synchronize()
    rows = prompt.shape[1] + (0 if fe is None else fe.shape[1])
    shape_ok = tuple(logits.shape) == (1, rows,
                                       padded_vocab(c.arch.vocab_size))
    finite = bool(torch.isfinite(logits).all())
    log(f"serve: {arch} full-width logits {tuple(logits.shape)} "
        f"finite={finite}")
    check(shape_ok and finite, f"serve: {arch} logits NaN/inf or misshapen")
    return pod


def _llama_reqs(GenRequest, vocab: int) -> list:
    """The paged pods' 16 requests: 8 prompts of 64-512 tokens, then 8 of
    300-512 sharing a 256-token prefix (declared shared), 32 new tokens
    each."""
    import numpy as np
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, 256)
    reqs = [GenRequest(rid=i, prompt=rng.integers(
                0, vocab, int(rng.integers(64, 513))), max_new_tokens=32)
            for i in range(8)]
    for i in range(8, 16):
        tail = rng.integers(0, vocab, int(rng.integers(300, 513)) - 256)
        reqs.append(GenRequest(rid=i, prompt=np.concatenate([shared, tail]),
                               max_new_tokens=32, prefix_len=256))
    return reqs


def phase_serve(torch, state, workdir: Path) -> None:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.orchestrator import GenRequest

    rt = Runtime(workdir / "full")
    failures = []
    drops = []                   # moonshot's MoE keep masks, per dispatch

    def run(arch, build_reqs, expect, **kw):
        rt.build(FULL_IMAGEFILE.format(arch=arch), tag=arch)
        try:
            pod = _drive_pod(torch, state, rt, arch, build_reqs(arch),
                             expect, **kw)
            if arch == "moonshot-v1-16b-a3b":
                _report_moe_drops(pod, drops)
            for e in pod.engines:
                e.release()
        except PhaseError as e:
            failures.append(str(e))
            log(f"FAIL serve: {e}")
        torch.cuda.empty_cache()

    def llama_reqs(arch):
        return _llama_reqs(GenRequest, get_config(arch).vocab_size)

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

    def frontend_reqs(arch):
        # 12 requests of 64-512 prompt tokens: 4 with the full frontend
        # buffer (musicgen 64 rows, internvl2 256), 4 with part of it, 4
        # with none
        cfg = get_config(arch)
        F, D = cfg.frontend_len, cfg.d_model
        rng = np.random.default_rng(14)
        reqs = []
        for i in range(12):
            fl = (F, int(rng.integers(1, F)), 0)[i % 3]
            fe = (0.02 * rng.standard_normal((fl, D)).astype(np.float32)
                  if fl else None)
            reqs.append(GenRequest(
                rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                           int(rng.integers(64, 513))),
                max_new_tokens=32, frontend=fe))
        return reqs

    run("llama3.2-3b", llama_reqs,
        {"paged_attention": ("decode", 28),
         "flash_attention_fwd": ("prefill", 28)},
        n_slots=8, max_len=1024, paged=True, page_size=16, prefix_cache=True)
    run("stablelm-3b", llama_reqs,
        {"paged_attention": ("decode", 32),
         "flash_attention_fwd": ("prefill", 32)},
        n_slots=8, max_len=1024, paged=True, page_size=16, prefix_cache=True)
    run("mamba2-2.7b", mamba2_reqs, {"ssd": ("prefill", 64)},
        n_slots=8, max_len=1024, paged=False)
    run("recurrentgemma-2b", recurrentgemma_reqs,
        {"rglru_scan": ("prefill", 18),
         "flash_attention_fwd": ("prefill", 8)},
        n_slots=8, max_len=4096, paged=False)
    run("nemotron-4-15b", llama_reqs,
        {"paged_attention": ("decode", 32),
         "flash_attention_fwd": ("prefill", 32)},
        n_slots=8, max_len=1024, paged=True, page_size=16, prefix_cache=True)
    run("moonshot-v1-16b-a3b", llama_reqs,
        {"paged_attention": ("decode", 48),
         "flash_attention_fwd": ("prefill", 48)},
        watch=_moe_drop_counter(drops),
        n_slots=8, max_len=1024, paged=True, page_size=16, prefix_cache=True)
    # the JAX scheduler keeps frontend requests out of the prefix cache:
    # their leading KV rows are per-request embeddings
    run("musicgen-medium", frontend_reqs,
        {"paged_attention": ("decode", 48),
         "flash_attention_fwd": ("prefill", 48)},
        n_slots=8, max_len=1024, paged=True, page_size=16)
    run("internvl2-2b", frontend_reqs,
        {"paged_attention": ("decode", 24),
         "flash_attention_fwd": ("prefill", 24)},
        n_slots=8, max_len=1024, paged=True, page_size=16)
    check(not failures, "; ".join(failures))


@contextmanager
def _moe_drop_counter(calls):
    """While entered, every MoE dispatch appends its (T, k) ``keep`` mask
    (a device tensor, read after the run) to ``calls``."""
    from repro_torch.models import moe as moe_mod
    real = moe_mod.dispatch_positions

    def counting(idx, n_experts, C, before=None):
        pos, keep, slot = real(idx, n_experts, C, before)
        calls.append(keep.reshape(idx.shape))
        return pos, keep, slot

    moe_mod.dispatch_positions = counting
    try:
        yield
    finally:
        moe_mod.dispatch_positions = real


def _report_moe_drops(pod, calls):
    """Print the assignments each prefill dropped to capacity, summed over
    the MoE layers and split between the prompt's rows and the bucket's
    right-pad rows (the scheduler's prefill spans give the real rows). A
    decode step routes the slot bank's rows (T = n_slots), a prefill its
    bucket (T >= 16): the calls split by T."""
    eng = pod.engines[0]
    n_moe = sum(st.count for st in eng.container.model.stages
                if "moe" in st.unit)
    pre = [c for c in calls if c.shape[0] != eng.n_slots]
    dec = [c for c in calls if c.shape[0] == eng.n_slots]
    real = [e.attr("positions") for e in eng.trace.events()
            if e.name == "prefill"]
    check(len(pre) == n_moe * len(real),
          f"serve: moonshot MoE dispatches {len(pre)} do not split into "
          f"{len(real)} prefills of {n_moe} layers")
    rows = []
    for i, n in enumerate(real):
        layers = pre[i * n_moe:(i + 1) * n_moe]
        T, k = layers[0].shape
        dropped = [int((~m[:n]).sum()) for m in layers]
        dropped_pad = [int((~m[n:]).sum()) for m in layers]
        rows.append(f"{sum(dropped)}/{n * k * n_moe} prompt + "
                    f"{sum(dropped_pad)}/{(T - n) * k * n_moe} pad")
    k = pre[0].shape[1] if pre else 0
    log(f"serve: moonshot-v1-16b-a3b assignments dropped to capacity per "
        f"prefill (rows x top-{k} x {n_moe} MoE layers, prompt rows then "
        f"right-pad rows): {'; '.join(rows)}; decode steps dropped "
        f"{sum(int((~m).sum()) for m in dec)} of "
        f"{sum(m.numel() for m in dec)}")


# ---------------------------------------------------------------------------
# batch: the whole-batch serve path (Container.prefill_fn / decode_fn, the
# lockstep decode at one scalar position) at full width
# ---------------------------------------------------------------------------

BATCH_IMAGEFILE = """\
FROM scratch
ARCH {arch}
SHAPE prefill_32k seq_len=1024 global_batch=8
MESH local
PRECISION compute={dtype} params={dtype}
"""
BATCH_B, BATCH_PROMPT, BATCH_GEN, BATCH_HAND = 8, 512, 32, 4
# kernel launches of one whole-batch prefill (tests/test_consistency.py's
# three archs); none may launch during the lockstep decode, which is
# contiguous and runs the plain path, as the reference's runs through XLA
BATCH_PREFILL_LAUNCHES = {
    "llama3.2-3b": {"flash_attention_fwd": 28},
    "recurrentgemma-2b": {"flash_attention_fwd": 8, "rglru_scan": 18},
    "mamba2-2.7b": {"ssd": 64},
}
# (b): 8 decode steps compared; 5 timed calls a block after one warm-up
BATCH_NATIVE_STEPS, BATCH_SAMPLES = 8, 5


def _batch_gate(counts: dict, want: dict, what: str) -> None:
    """Every kernel's launches equal ``want``'s (0 where it names none)."""
    bad = {k: (n, want.get(k, 0)) for k, n in counts.items()
           if n != want.get(k, 0)}
    check(not bad, f"batch: {what}: launches (got, expected) {bad}")


def _batch_tokens(torch, state, rt, arch: str) -> list[str]:
    """(a) for one arch, float32: prefill_fn over 8 prompts of 512 tokens,
    then the ``generate`` step (build_generate_loop(32)) from the scalar
    start 512, and decode_fn stepped by hand 4 times at a 0-d position on
    a copy of the cache; against a contiguous Pod serving the same
    prompts. Returns the failures."""
    import numpy as np
    from repro_torch.models.params import tree_map
    from repro_torch.orchestrator import ContinuousScheduler, GenRequest, Pod
    from repro_torch.serve.serve_step import greedy_sample

    tag = f"batch-{arch}"
    rt.build(BATCH_IMAGEFILE.format(arch=arch, dtype="float32"), tag=tag)
    c = rt.run(tag)
    params = c.init_params(0)
    vocab = c.arch.vocab_size
    prompts = np.random.default_rng(0).integers(
        0, vocab, (BATCH_B, BATCH_PROMPT))
    toks = torch.as_tensor(prompts, device=c.device)
    prefill = c.prefill_fn()
    decode = c.decode_fn()
    generate = c.compile_serve_step("generate", batch=BATCH_B,
                                    cache_len=c.cell.seq_len,
                                    gen_steps=BATCH_GEN)

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    last, cache = prefill(params, toks)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_counts = _main_path_counts(state)
    _batch_gate(prefill_counts, BATCH_PREFILL_LAUNCHES[arch],
                f"{arch} prefill")
    finite = bool(torch.isfinite(last).all())
    check(finite and tuple(last.shape)[0] == BATCH_B,
          f"batch: {arch} prefill logits {tuple(last.shape)} finite={finite}")
    first = greedy_sample(last, vocab)[:, None]
    del last
    hand_cache = tree_map(torch.clone, cache)

    _reset_counts()
    t0 = time.perf_counter()
    gen, _ = generate(params, cache, first, BATCH_PROMPT)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    hand = []
    tok = first
    for i in range(BATCH_HAND):
        logits, hand_cache = decode(
            params, hand_cache, tok,
            torch.tensor(BATCH_PROMPT + i, dtype=torch.int32,
                         device=c.device))
        tok = greedy_sample(logits, vocab)[:, None]
        hand.append(tok[:, 0])
    torch.cuda.synchronize()
    counts = _main_path_counts(state)
    _batch_gate(counts, {}, f"{arch} decode")
    del cache, hand_cache, logits
    batch = torch.cat([first, gen], dim=1).tolist()     # 33 a request
    hand = torch.stack(hand, dim=1).tolist()
    hand_same = hand == [row[:BATCH_HAND] for row in gen.tolist()]
    log(f"batch: {arch} f32 prefill_fn {BATCH_B} x {BATCH_PROMPT} in "
        f"{t_prefill:.3f} s (first call), launches {prefill_counts}; "
        f"generate {BATCH_GEN} steps from the scalar start {BATCH_PROMPT} "
        f"in {t_gen:.3f} s and decode_fn x {BATCH_HAND}, launches {counts}; "
        f"the hand-stepped tokens equal the loop's: {hand_same}")

    reqs = [GenRequest(rid=i, prompt=prompts[i],
                       max_new_tokens=BATCH_GEN + 1) for i in range(BATCH_B)]
    pod = Pod(rt, tag, replicas=1, n_slots=BATCH_B,
              max_len=c.cell.seq_len, params=params)
    sched = ContinuousScheduler(pod)
    sched.submit(reqs)
    sched.run(max_ticks=10_000)
    torch.cuda.synchronize()
    pod_done = all(r.state == "done" for r in reqs)
    _release([pod])
    del pod, sched, params
    torch.cuda.empty_cache()
    want = dict(enumerate(batch))
    diffs = _token_diffs(want, reqs)
    log(f"batch: {arch} whole-batch tokens ({BATCH_GEN + 1} a request) "
        f"equal a contiguous Pod(n_slots={BATCH_B}, max_len="
        f"{c.cell.seq_len})'s: {not diffs and pod_done}")
    failures = []
    if not hand_same:
        failures.append(f"{arch}: decode_fn by hand {hand} != the loop's")
    if diffs or not pod_done:
        failures.append(f"{arch}: tokens differ from the Pod's at (rid, "
                        f"position) {diffs}: "
                        + _margins(torch, rt, tag, reqs, want, diffs))
    return failures


def _batch_timed(torch, fns: dict) -> dict:
    """Per-call ms of each of ``fns`` (CUDA events, after one warm-up
    each), in blocks of BATCH_SAMPLES calls in the order A B B A: each
    route timed twice, once before and once after the other, so a drift
    of the shared host shows as a gap between a route's two blocks.
    Returns {name: [first block's samples, second block's]}."""
    for fn in fns.values():
        fn()
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        block = []
        for _ in range(BATCH_SAMPLES):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[n]()
            b.record()
            b.synchronize()
            block.append(a.elapsed_time(b))
        times[n].append(block)
    return times


def _blocks_txt(blocks: list) -> str:
    return "; ".join(f"block {i + 1} median {statistics.median(b):.4f} "
                     f"(min {min(b):.4f}, max {max(b):.4f})"
                     for i, b in enumerate(blocks))


def _batch_routes(torch, state, rt) -> list[str]:
    """(b) llama3.2-3b bf16: the native route (``Model`` + ``ServeStepBuilder``
    built by hand) against the container route (``prefill_fn`` /
    ``decode_fn``) on the container's params: bit-identical last logits and
    8 decode steps, both prefills' launches gated; then prefill and decode
    timed on each route."""
    import numpy as np
    from repro_torch.models.transformer import Model
    from repro_torch.serve.serve_step import ServeStepBuilder, greedy_sample

    arch = "llama3.2-3b"
    rt.build(BATCH_IMAGEFILE.format(arch=arch, dtype="bfloat16"), tag="bf16")
    c = rt.run("bf16")
    params = c.init_params(0)
    vocab = c.arch.vocab_size
    L = c.cell.seq_len
    native = ServeStepBuilder(Model(c.arch, act_dtype=torch.bfloat16))
    routes = {
        "native": (torch.no_grad()(native.build_prefill(L)),
                   torch.no_grad()(native.build_decode())),
        "container": (c.prefill_fn(), c.decode_fn()),
    }
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab, (BATCH_B, BATCH_PROMPT)), device=c.device)
    out = {}
    for name, (prefill, decode) in routes.items():
        _reset_counts()
        last, cache = prefill(params, toks)
        torch.cuda.synchronize()
        _batch_gate(_main_path_counts(state), BATCH_PREFILL_LAUNCHES[arch],
                    f"{name} bf16 prefill")
        logits, tok = [], greedy_sample(last, vocab)[:, None]
        _reset_counts()
        for i in range(BATCH_NATIVE_STEPS):
            lg, cache = decode(params, cache, tok, BATCH_PROMPT + i)
            logits.append(lg)
            tok = greedy_sample(lg, vocab)[:, None]
        torch.cuda.synchronize()
        _batch_gate(_main_path_counts(state), {}, f"{name} bf16 decode")
        out[name] = (last, logits, cache, tok)
    same_last = torch.equal(out["native"][0], out["container"][0])
    same_steps = all(torch.equal(a, b) for a, b in
                     zip(out["native"][1], out["container"][1]))
    # timing: the prefill again, and one decode step at the next position
    # (rewritten in place each call), each route before and after the other
    pos = BATCH_PROMPT + BATCH_NATIVE_STEPS
    ms_p = _batch_timed(torch, {
        n: (lambda f=f: f(params, toks)) for n, (f, _) in routes.items()})
    ms_d = _batch_timed(torch, {
        n: (lambda f=f, c=out[n][2], t=out[n][3]: f(params, c, t, pos))
        for n, (_, f) in routes.items()})
    _reset_counts()
    card = state["card"]
    med = {}
    for step, ms in (("prefill", ms_p), ("decode", ms_d)):
        med[step] = {n: statistics.median(sum(b, [])) for n, b in ms.items()}
        for name in routes:
            log(f"batch: llama3.2-3b bf16 {name} route, "
                + (f"prefill {BATCH_B} x {BATCH_PROMPT}" if step == "prefill"
                   else "one decode step")
                + f": median {med[step][name]:.4f} ms of "
                f"{2 * BATCH_SAMPLES} (CUDA events, blocks native, "
                f"container, container, native); {_blocks_txt(ms[name])}; "
                f"samples {[round(t, 4) for t in sum(ms[name], [])]} "
                f"[{card}]")
    log(f"batch: container / native: prefill "
        f"{med['prefill']['container'] / med['prefill']['native']:.4f}, "
        f"decode {med['decode']['container'] / med['decode']['native']:.4f}"
        f" [{card}]; last logits bit-identical {same_last}, "
        f"{BATCH_NATIVE_STEPS} decode steps bit-identical {same_steps}")
    del out, params, routes
    torch.cuda.empty_cache()
    return [] if same_last and same_steps else [
        f"native vs container: last logits equal {same_last}, decode steps "
        f"equal {same_steps}"]


def phase_batch(torch, state, workdir: Path) -> None:
    from repro_torch.core.runtime import Runtime

    rt = Runtime(workdir / "batch")
    failures = []
    for arch in BATCH_PREFILL_LAUNCHES:
        try:
            failures += _batch_tokens(torch, state, rt, arch)
        except PhaseError as e:
            failures.append(str(e))
        torch.cuda.empty_cache()
    failures += _batch_routes(torch, state, rt)
    check(not failures, "batch: " + "; ".join(failures))


# the cli phase's serve commands (full-width llama3.2-3b)
CLI_SERVE = ("--pods", "2", "--replicas", "1", "--slots", "8", "--requests",
             "32", "--prompt-len", "512", "--gen", "32", "--paged",
             "--page-size", "16", "--prefix-cache", "--shared-prefix", "256",
             "--policy", "prefix-hash")
CLI_STATIC = ("--mode", "static", "--slots", "8", "--requests", "16",
              "--prompt-len", "512", "--gen", "32")


def _flag(argv, name: str) -> int:
    return int(argv[argv.index(name) + 1])


def phase_cli(torch, state, workdir: Path) -> None:
    """The user's entry points, in process so the kernel counters can be
    read: ``repro_torch.cli.main`` for build/images/inspect/serve/ps/top,
    the obs validator for the exported trace. The serve driver's pods and
    its result are recorded by wrapping ``_make_pod`` and ``main`` of
    ``repro_torch.launch.serve`` (the CLI imports ``main`` when it runs)."""
    from repro_torch import cli
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.orchestrator.obs import validate

    root = workdir / "cli"
    root.mkdir()
    imagefile = root / "Imagefile"
    imagefile.write_text(FULL_IMAGEFILE.format(arch="llama3.2-3b"))
    trace = root / "t.json"
    layers = get_config("llama3.2-3b").n_layers

    def run(*argv):
        log(f"cli: stevedore {' '.join(argv)}")
        rc = cli.main(["--root", str(root / "rt"), *argv])
        check(rc == 0, f"cli: {argv[0]} exited {rc}")

    pods, outs = [], []
    real_make, real_main = serve_mod._make_pod, serve_mod.main

    def make_pod(*a, **k):
        pods.append(real_make(*a, **k))
        return pods[-1]

    def serve_main(argv=None):
        outs.append(real_main(argv))
        return outs[-1]

    def serve(*argv):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        run("serve", "stable", *argv)
        torch.cuda.synchronize()
        counts = _main_path_counts(state)
        return outs[-1], counts, torch.cuda.max_memory_allocated()

    run("build", "-t", "stable", str(imagefile))
    run("images")
    run("inspect", "stable")
    serve_mod._make_pod, serve_mod.main = make_pod, serve_main
    try:
        out, counts, peak = serve(*CLI_SERVE, "--trace", str(trace))
        engines = [e for p in pods for e in p.engines]
        steps = sum(e.decode_ticks for e in engines)
        prefills = sum(e._c_prefill_disp.value for e in engines)
        want = {"paged_attention": layers * steps,
                "flash_attention_fwd": layers * prefills}
        pre_s = sum(e.prefill_s for e in engines)
        per_pod = [sum(e._c_prefill_disp.value for e in p.engines)
                   for p in pods]
        d = out["decomposition"]
        n_req = _flag(CLI_SERVE, "--requests")
        log(f"cli: serve --pods 2 --policy prefix-hash: {out['requests']}/"
            f"{n_req} requests, {out['tokens']} tokens in "
            f"{out['wall_s']:.2f} s; prefills per pod {per_pod}; "
            f"prefix hits {out['prefix_cache']['hits']} / misses "
            f"{out['prefix_cache']['misses']}; launches {counts}, expected "
            f"K1 {layers} x {steps} decode steps, K2 {layers} x {prefills} "
            "prefills")
        log(f"cli: serve decode {out['decode_tok_per_s']:.1f} tokens/s, "
            f"prefill {out['prefill_positions']} positions in {pre_s:.3f} s "
            f"= {out['prefill_positions'] / pre_s:.1f} tokens/s; ttft p50 "
            f"{d['ttft_p50_ticks']} / p99 {d['ttft_p99_ticks']} ticks, itl "
            f"p50 {d['itl_p50_ticks']:.3f} / p99 {d['itl_p99_ticks']:.3f} "
            f"ticks/token; latency p50 {out['p50_latency_ticks']} / p99 "
            f"{out['p99_latency_ticks']} ticks; peak memory "
            f"{peak / 2**30:.2f} GiB [{state['card']}]")
        check(out["requests"] == n_req, f"cli: {out['requests']} of {n_req} "
                                        "requests completed")
        check(out["prefix_cache"]["hits"] >= 1, "cli: no prefix hit")
        # placement, as a CPU run of the same command on llama3.2-3b-smoke
        # predicts (the router works on ticks, not widths): the trace is one
        # prefix family, so prefix-hash puts every request on the pod that
        # owns its digest (which pod depends on the random pod ids), with
        # no spillover, 31 prefix hits and the one miss that fills the cache
        placed = (sorted(per_pod), out["fleet"]["spilled"],
                  out["prefix_cache"]["hits"], out["prefix_cache"]["misses"])
        check(placed == ([0, n_req], 0, n_req - 1, 1),
              f"cli: (prefills per pod, spilled, prefix hits, misses) "
              f"{placed} != the CPU prediction {([0, n_req], 0, n_req - 1, 1)}")
        for name, n in counts.items():
            check(n == want.get(name, 0),
                  f"cli: serve {name} launches {n} != {want.get(name, 0)}")
        for e in engines:
            e.release()
        pods.clear()
        del engines          # the last references to the pods' weights

        out, counts, peak = serve(*CLI_STATIC)
        n_req, slots = _flag(CLI_STATIC, "--requests"), _flag(CLI_STATIC,
                                                               "--slots")
        waves = -(-n_req // slots)
        log(f"cli: serve --mode static: {out['requests']} requests, "
            f"{out['tokens']} useful tokens; decode "
            f"{out['decode_tok_per_s']:.1f} tokens/s ({out['decode_s']:.3f} "
            f"s), prefill {out['prefill_s']:.3f} s for {waves} waves of "
            f"{slots}; launches {counts}, expected K2 {layers} x {waves} "
            f"waves; peak memory {peak / 2**30:.2f} GiB [{state['card']}]")
        check(out["requests"] == n_req, "cli: static run lost requests")
        for name, n in counts.items():
            want_n = layers * waves if name == "flash_attention_fwd" else 0
            check(n == want_n, f"cli: static {name} launches {n} != {want_n}")
    finally:
        serve_mod._make_pod, serve_mod.main = real_make, real_main
        pods.clear()
        outs.clear()
        torch.cuda.empty_cache()
    run("ps")
    run("top")
    rc = validate.main([str(trace)])
    check(rc == 0, f"cli: the exported trace does not validate ({rc})")


# ---------------------------------------------------------------------------
# examples: the port's linter with JAX unimportable, and the four user
# examples (repro_torch.examples) at their own configurations
# ---------------------------------------------------------------------------

LINT_ARGS = ("lint", "--strict", "--ratchet", "lint-ratchet.json", "src",
             "tests")
# a span kind added to the port's table (and to its exporter) with no
# transition entry: the port's span-lifecycle reads this file
LINT_SEEDS = (('"evict", "reroute")', '"evict", "reroute", "park")'),
              ('elif e.name == "reroute":\n                    events',
               'elif e.name in ("reroute", "park"):\n                    events'))
TRACING_REL = "src/repro_torch/orchestrator/obs/tracing.py"


def _no_jax_env(workdir: Path) -> dict:
    """An environment whose PYTHONPATH starts with a directory where
    ``import jax`` and ``import repro`` raise, then the port."""
    poison = workdir / "poison"
    for name in ("jax", "repro"):
        (poison / name).mkdir(parents=True, exist_ok=True)
        (poison / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable here')\n")
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(poison), str(SRC)])}


def _examples_lint(workdir: Path) -> None:
    env = _no_jax_env(workdir)
    cmd = [sys.executable, "-m", "repro_torch.cli"]
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, *LINT_ARGS], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    out = proc.stdout.strip().splitlines()
    log(f"examples: lint {' '.join(LINT_ARGS[1:])} -> exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.1f} s: "
        f"{out[-1] if out else proc.stderr.strip()[-300:]}")
    check(proc.returncode == 0 and len(out) == 1 and out[0].startswith(
        "repro lint: 0 error(s), 0 warning(s) across "),
          f"examples: lint on the tree: {proc.stdout[-800:]}"
          f"{proc.stderr[-800:]}")

    text = (ROOT / TRACING_REL).read_text()
    for old, new in LINT_SEEDS:
        check(text.count(old) == 1, f"examples: seed anchor {old!r}")
        text = text.replace(old, new)
    seeded = workdir / "lint-seeded" / TRACING_REL
    seeded.parent.mkdir(parents=True)
    seeded.write_text(text)
    proc = subprocess.run([*cmd, "lint", str(seeded), "--rule",
                           "span-lifecycle"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    errors = [ln for ln in proc.stdout.splitlines()
              if " error [span-lifecycle] " in ln]
    log(f"examples: lint on a copy of the port's tracing.py with a span "
        f"kind and no transition -> exit {proc.returncode}: {errors}")
    check(proc.returncode == 1 and len(errors) == 1
          and "missing ['park']" in errors[0]
          and "repro lint: 1 error(s), 0 warning(s)" in proc.stdout,
          f"examples: the seeded span kind: {proc.stdout[-800:]}"
          f"{proc.stderr[-800:]}")


def _example_run(torch, state, name: str, fn, argv) -> tuple:
    """``fn(argv)`` with the counters at 0 just before and read just after;
    returns (result, counts, seconds, peak bytes). Fails if K2 or its
    backward was called at a shape (and dtype) that the kernels phase did
    not hold against its plain version."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"examples: repro_torch.examples.{name}.main({argv})")
    shapes, real = set(), fa_ops.flash_attention_fwd_cuda

    def k2(q, k, v, *, causal=True, window=0, **kw):
        shapes.add((q.shape[0], q.shape[1], k.shape[1], q.shape[3],
                    q.shape[2], k.shape[2], int(window),
                    str(q.dtype).removeprefix("torch."), bool(causal)))
        return real(q, k, v, causal=causal, window=window, **kw)
    fa_ops.flash_attention_fwd_cuda = k2
    n_bwd = len(state["k2_bwd_calls"])
    _reset_counts()
    t0 = time.perf_counter()
    try:
        res = fn(argv)
        torch.cuda.synchronize()
    finally:
        fa_ops.flash_attention_fwd_cuda = real
    seconds = time.perf_counter() - t0
    counts = _main_path_counts(state)
    checked = {(*c, True) for c in state.get("k2_checked", ())}
    log(f"examples: {name} K2 shapes (B, Hq, Hkv, d, Sq, Sk, window, dtype, "
        f"causal) {sorted(shapes)}")
    check(shapes <= checked, f"examples: {name} called K2 at shapes the "
          f"kernels phase did not check: {sorted(shapes - checked)}")
    bwd = set(state["k2_bwd_calls"][n_bwd:])
    if bwd:
        log(f"examples: {name} K2 backward shapes {sorted(bwd)}")
    check(bwd <= state.get("k2_bwd_checked", set()),
          f"examples: {name} called K2's backward at shapes the kernels "
          f"phase did not check: "
          f"{sorted(bwd - state.get('k2_bwd_checked', set()))}")
    return res, counts, seconds, torch.cuda.max_memory_allocated()


def _example_gate(name: str, counts: dict, want_k2: int, seconds: float,
                  peak: int, card: str, extra: str = "",
                  want_bwd: int = 0) -> None:
    """K2 ``want_k2`` times, its backward ``want_bwd`` times (a training
    example: once a step per layer), nothing else."""
    want = {"flash_attention_fwd": want_k2, "flash_attention_bwd": want_bwd}
    log(f"examples: {name}: {seconds:.2f} s, peak memory "
        f"{peak / 2**30:.2f} GiB{extra}; launches {counts}, expected "
        f"{want} [{card}]")
    for k, n in counts.items():
        check(n == want.get(k, 0), f"examples: {name} {k} launches {n} != "
              f"{want.get(k, 0)}")


def _finite(xs) -> bool:
    return all(x == x and abs(x) != float("inf") for x in xs)


def phase_examples(torch, state, workdir: Path) -> None:
    """(a) the port's ``lint`` with JAX unimportable; (b) the four
    examples in process, through their ``main(argv)``, on the card at
    their own configurations, each root deleted after it."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.examples import (hpc_migration, quickstart,
                                      serve_batched, train_100m)
    from repro_torch.launch import serve as serve_mod

    _examples_lint(workdir)
    card = state["card"]
    base = workdir / "examples"
    smoke = get_config("llama3.2-3b-smoke").n_layers

    root = base / "quickstart"
    res, counts, s, peak = _example_run(torch, state, "quickstart",
                                        quickstart.main, ["--root", str(root)])
    losses = res["losses"]
    _example_gate("quickstart", counts, smoke * len(losses), s, peak, card,
                  f"; losses step 1 {losses[0]:.4f}, step 15 "
                  f"{losses[-1]:.4f}", want_bwd=smoke * len(losses))
    check(len(losses) == 15 and _finite(losses) and losses[-1] < losses[0],
          f"examples: quickstart losses {losses}")
    shutil.rmtree(root)

    root = base / "hpc_migration"
    res, counts, s, peak = _example_run(torch, state, "hpc_migration",
                                        hpc_migration.main,
                                        ["--root", str(root)])
    losses = res["losses"]
    _example_gate("hpc_migration", counts, smoke * len(losses), s, peak,
                  card, f"; losses step 1 {losses[0]:.4f}, step 10 "
                        f"{losses[-1]:.4f}", want_bwd=smoke * len(losses))
    check(len(losses) == 10 and _finite(losses) and losses[-1] < losses[0],
          f"examples: hpc_migration losses {losses}")
    pushed = (res["layers_transferred"], res["layers_reused"])
    check(pushed == (2, 8), f"examples: hpc push (new, reused) {pushed} "
                            "!= (2, 8)")
    shutil.rmtree(root)

    root = base / "serve_batched"
    pods, real_make = [], serve_mod._make_pod

    def make_pod(*a, **k):
        pods.append(real_make(*a, **k))
        return pods[-1]
    serve_mod._make_pod = make_pod
    try:
        res, counts, s, peak = _example_run(
            torch, state, "serve_batched", serve_batched.main,
            ["--root", str(root)])
        engines = [e for p in pods for e in p.engines]
        prefills = sum(e._c_prefill_disp.value for e in engines)
        layers = engines[0].container.arch.n_layers
    finally:
        serve_mod._make_pod = real_make
        pods.clear()
    budgets = serve_mod._tail_budgets(32, 8)
    got = [len(res["request_tokens"].get(i, ())) for i in range(8)]
    _example_gate("serve_batched", counts, layers * prefills, s, peak, card,
                  f"; {res['requests']} requests, tokens {got} (budgets "
                  f"{budgets}), decode {res['decode_tok_per_s']:.1f} "
                  f"tokens/s; K2 = {layers} layers x {prefills} prefills")
    check(res["requests"] == 8 and got == budgets,
          f"examples: serve_batched tokens {got} != budgets {budgets}")
    del engines
    shutil.rmtree(root)

    root = base / "train_100m"
    res, counts, s, peak = _example_run(torch, state, "train_100m",
                                        train_100m.main, ["--root", str(root)])
    steps = res["steps"]
    losses = [res["losses"][k] for k in sorted(res["losses"])]
    recs = [json.loads(ln) for ln in (Path(res["overlay"]) / "metrics.jsonl")
            .read_text().splitlines()]
    step_s = sum(r["step_seconds"] for r in recs)
    tokens = steps * 4 * 128              # the Imagefile's global_batch, seq_len
    _example_gate("train_100m", counts, 8 * steps, s, peak, card,
                  f"; {steps} steps, loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}; {tokens / step_s:.1f} tokens/s over "
                  f"the steps' {step_s:.2f} s ({tokens / s:.1f} over the "
                  f"wall, {steps // 50 + 1} checkpoint writes included)",
                  want_bwd=8 * steps)
    check(steps == 300 and len(losses) == 300 and _finite(losses)
          and losses[-1] < losses[0],
          f"examples: train_100m losses {losses[:3]} ... {losses[-3:]}")
    shutil.rmtree(root)


# ---------------------------------------------------------------------------
# fabric: the cross-host serving fabric on the card -- loopback and process
# fleets of full-width llama3.2-3b, a worker killed mid-decode
# ---------------------------------------------------------------------------

# the reference harness's precision (tests/test_fabric.py, fig12_fabric.py):
# a rerouted request's KV is recomputed by a suffix prefill (K2, GEMMs of
# M = S rows) where the unkilled run wrote it a decode tick at a time (K1,
# GEMMs of M = n_slots rows); float32 keeps those roundings far below the
# greedy margins
FABRIC_IMAGEFILE = """\
FROM scratch
ARCH llama3.2-3b
MESH local
PRECISION compute=float32 params=float32
"""
# every fleet member: 8 slots, paged, pool of the contiguous bank's size
# (8 x 576 / 16 = 288 pages; a request spans at most 512 + 32 + 4)
FABRIC_POD = dict(replicas=1, n_slots=8, max_len=576, paged=True,
                  page_size=16)
FABRIC_REQUESTS = 16
# the CLI arm: serve --fabric proc on the bf16 image
CLI_FABRIC = ("--fabric", "proc", "--pods", "2", "--min-pods", "2",
              "--replicas", "1", "--slots", "8", "--requests", "16",
              "--prompt-len", "512", "--gen", "32", "--paged",
              "--page-size", "16")


def _fabric_trace(GenRequest, vocab: int):
    """16 requests of 64-512 prompt tokens and 32 new, 4 arriving a tick."""
    import numpy as np
    rng = np.random.default_rng(15)
    return [GenRequest(rid=i, prompt=rng.integers(
                0, vocab, int(rng.integers(64, 513))), max_new_tokens=32,
                arrival=i // 4) for i in range(FABRIC_REQUESTS)]


# a worker is killed once it holds a request with this many committed
# tokens (of 32): its resume re-prefills them, so the survivor recomputes
# the KV of generated tokens, not only of the prompt
KILL_AFTER_TOKENS = 16


def _kill_mid_decode(router, kill):
    """Step until a member holds an unfinished request with at least
    KILL_AFTER_TOKENS committed tokens, then ``kill`` it; returns (victim,
    its in-flight rids)."""
    while router.busy and router.tick < 10_000:
        victim = next((m for m in router.members.values()
                       if any(KILL_AFTER_TOKENS <= len(r.tokens)
                              < r.max_new_tokens
                              for r in m.assigned.values())), None)
        if victim is not None:
            inflight = sorted(victim.assigned)
            kill(victim)
            return victim, inflight
        router.step()
    raise PhaseError("fabric: no member was ever mid-decode")


def _drain_fleet(router) -> None:
    while router.busy and router.tick < 10_000:
        router.step()
    check(not router.busy, "fabric: the fleet did not drain")


def _token_diffs(want: dict, reqs) -> list[tuple[int, int]]:
    """(rid, first position) of every request whose tokens differ."""
    out = []
    for r in reqs:
        w, g = want[r.rid], list(r.tokens)
        if w != g:
            out.append((r.rid, next((i for i, (a, b) in enumerate(zip(w, g))
                                     if a != b), min(len(w), len(g)))))
    return out


def _margins(torch, rt, tag, reqs, want, diffs) -> str:
    """The unkilled run's top-2 logit margin at each divergent position:
    the seeded model's full forward over prompt + the tokens before it."""
    import numpy as np
    c = rt.run(tag)
    params = c.init_params(0)
    by_rid = {r.rid: r for r in reqs}
    out = []
    for rid, pos in diffs:
        seq = np.concatenate([by_rid[rid].prompt,
                              np.asarray(want[rid][:pos], np.int64)])
        with torch.no_grad():
            logits, _ = c.model.forward(
                params, torch.as_tensor(seq[None], device=c.device))
        top = torch.topk(logits[0, -1, :c.arch.vocab_size].float(), 2)
        out.append(f"rid {rid} position {pos}: unkilled top-2 "
                   f"{top.indices.tolist()} margin "
                   f"{float(top.values[0] - top.values[1]):.4e}")
    del params, logits
    torch.cuda.empty_cache()
    return "; ".join(out)


def _smi(query: str) -> str:
    smi = subprocess.run(
        ["nvidia-smi", query, "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"fabric: nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip()


def _device_used_mib() -> int:
    """The card's memory in use, all processes, per ``nvidia-smi``."""
    return int(_smi("--query-gpu=memory.used").splitlines()[0])


def _opens_card(pid: int) -> bool:
    """Whether process ``pid`` holds a card's device node open (it has a
    CUDA context there), read from outside through ``/proc/<pid>/fd``."""
    import os
    import re
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            if re.fullmatch(r"/dev/nvidia\d+", os.readlink(fd)):
                return True
        except OSError:             # closed since the listing
            continue
    return False


def _release(pods) -> None:
    """Drop every engine's device state and the pod's params, so the
    memory frees even while a pod object is still referenced."""
    for pod in pods:
        for e in pod.engines:
            e.release()
        pod.drop_params(pod.image.digest)


def phase_fabric(torch, state, workdir: Path) -> None:
    """(a) 2 loopback pods, unkilled; (b) the same, one killed mid-decode;
    (c) 2 worker processes, one killed with SIGKILL mid-decode; (d) the
    CLI's ``serve --fabric proc`` on the bf16 image, then ps and top.
    Counters are reset before (a)'s and (b)'s runs and read after: in
    process, the loopback members' launches are this process's."""
    import io
    import math
    import os
    import signal
    from contextlib import redirect_stdout

    from repro_torch import cli
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.params import tree_leaves
    from repro_torch.orchestrator import (ContinuousScheduler, FabricRouter,
                                          GenRequest, Pod, load_fleet_spans,
                                          loopback_spawner, proc_spawner)
    from repro_torch.orchestrator.obs import (validate_fleet_closure,
                                              validate_span_log)

    arch = "llama3.2-3b"
    cfg = get_config(arch)
    layers = cfg.n_layers
    card = state["card"]
    rt = Runtime(workdir / "fabric")
    rt.build(FABRIC_IMAGEFILE, tag="f32")
    image = rt.pull("f32")
    weights_mib = sum(math.prod(d.shape) for d in tree_leaves(
        rt.run("f32").param_defs)) * 4 / 2**20

    def trace():
        return _fabric_trace(GenRequest, cfg.vocab_size)

    # the oracle: one pod and one scheduler serve the whole trace
    t0 = time.perf_counter()
    pod = Pod(rt, "f32", **FABRIC_POD)
    sched = ContinuousScheduler(pod)
    reqs = trace()
    sched.submit(reqs)
    sched.run(max_ticks=10_000)
    torch.cuda.synchronize()
    check(all(r.state == "done" and len(r.tokens) == 32 for r in reqs),
          "fabric: the oracle pod left requests unfinished")
    want = {r.rid: list(r.tokens) for r in reqs}
    log(f"fabric: oracle (1 pod + ContinuousScheduler, {arch} f32) "
        f"{len(reqs)} requests, prompts {sorted(len(r.prompt) for r in reqs)}"
        f", {sum(len(t) for t in want.values())} tokens in "
        f"{time.perf_counter() - t0:.2f} s, {sched.tick} ticks")
    _release([pod])
    del pod, sched
    torch.cuda.empty_cache()

    failures = []

    def loopback(kill: bool):
        """One loopback arm: 2 pods (min 2), launch gates over every member
        the run spawned (the victim and its replacement too)."""
        name = "kill" if kill else "unkilled"
        workers = []
        base = loopback_spawner(rt, image, pod_kwargs=FABRIC_POD)

        def spawn(pod_id, start_tick):
            tr = base(pod_id, start_tick)
            workers.append(tr.worker)
            return tr
        torch.cuda.reset_peak_memory_stats()
        router = FabricRouter(spawn, runtime=rt, pods=2, min_pods=2,
                              fleet=f"loop-{name}")
        reqs = trace()
        router.submit(reqs)
        _reset_counts()
        t0 = time.perf_counter()
        victim = inflight = None
        if kill:
            victim, inflight = _kill_mid_decode(
                router, lambda m: m.transport.kill())
            kill_tick = router.tick
        _drain_fleet(router)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _main_path_counts(state)
        engines = [e for w in workers for e in w.pod.engines]
        steps = sum(e.decode_ticks for e in engines)
        prefills = sum(e._c_prefill_disp.value for e in engines)
        fab = router.status()["fabric"]
        buffers = router.trace_buffers()
        validate_span_log(buffers)
        closure = validate_fleet_closure(buffers)
        router.close()
        peak = torch.cuda.max_memory_allocated()
        toks = sum(len(r.tokens) for r in reqs)
        log(f"fabric: ({'b' if kill else 'a'}) loopback {name}: "
            f"{sum(r.state == 'done' for r in reqs)}/{len(reqs)} done, "
            f"{toks} tokens in {wall:.2f} s, {router.tick} router ticks; "
            f"members spawned {fab['spawned']}, evictions "
            f"{fab['evictions']}, reroutes {fab['reroutes']}"
            + (f" (killed {victim.pod_id} at tick {kill_tick} with "
               f"{len(inflight)} in flight: rids {inflight})" if kill else "")
            + f"; closure {closure}; prefills {prefills}, decode steps "
            f"{steps}, resumes {sum(e.resumes for e in engines)}; launches "
            f"{counts}, expected K1 {layers} x {steps}, K2 {layers} x "
            f"{prefills}; peak memory {peak / 2**30:.2f} GiB "
            f"(every member of the arm, in this process) [{card}]")
        diffs = _token_diffs(want, reqs)
        errs = []
        if diffs:
            errs.append(f"({name}) tokens differ from the oracle: "
                        + _margins(torch, rt, "f32", reqs, want, diffs))
        if not all(r.state == "done" and len(r.tokens) == 32 for r in reqs):
            errs.append(f"({name}) requests lost or short")
        if closure["routed"] != closure["closed"] or \
                closure["routed"] != len(reqs):
            errs.append(f"({name}) closure {closure}")
        if counts["paged_attention"] != layers * steps or \
                counts["flash_attention_fwd"] != layers * prefills:
            errs.append(f"({name}) launches {counts} != K1 {layers * steps}"
                        f", K2 {layers * prefills}")
        others = {k: v for k, v in counts.items() if v and k not in (
            "paged_attention", "flash_attention_fwd")}
        if others:
            errs.append(f"({name}) launches off the path: {others}")
        if kill:
            rerouted = [r for r in reqs if r.reroutes]
            if fab["evictions"] != 1 or not rerouted:
                errs.append(f"({name}) evictions {fab['evictions']}, "
                            f"{len(rerouted)} rerouted")
            if any(r.reroutes != 1 for r in rerouted) or \
                    sorted(r.rid for r in rerouted) != inflight:
                errs.append(f"({name}) reroutes per rid "
                            f"{[(r.rid, r.reroutes) for r in rerouted]}, "
                            f"in flight at the kill {inflight}")
            if closure["rerouted"] != len(rerouted):
                errs.append(f"({name}) closure rerouted {closure}")
        elif fab["evictions"] or fab["reroutes"]:
            errs.append(f"({name}) evictions or reroutes without a kill")
        _release([w.pod for w in workers])
        torch.cuda.empty_cache()
        return errs

    failures += loopback(kill=False)
    failures += loopback(kill=True)

    # (c) one worker process per pod, each its own CUDA context, in a root
    # of its own (its span files alone under <root>/spans). The kernels are
    # built here, before the first spawn, so no worker runs nvcc while the
    # router waits on it
    _build.build()
    prt = Runtime(workdir / "fabric-proc")
    prt.build(FABRIC_IMAGEFILE, tag="f32")
    base = proc_spawner(prt.root, imagefile=FABRIC_IMAGEFILE,
                        pod_kwargs=FABRIC_POD)
    boots, procs = {}, {}

    def spawn(pod_id, start_tick):
        t_spawn = time.perf_counter()
        tr = base(pod_id, start_tick)
        procs[pod_id] = tr.proc
        recv = tr.recv

        def timed_recv(timeout=None):
            msg = recv(timeout)
            if msg and msg.get("t") == "ready" and pod_id not in boots:
                boots[pod_id] = (time.perf_counter() - t_spawn, msg["pid"])
            return msg
        tr.recv = timed_recv
        return tr

    # device memory from outside (nvidia-smi's per-process list shows every
    # process of this machine as pid 1, so the workers are told apart by
    # their open device nodes, and their memory is the card's total less
    # what was in use before they started)
    used0 = _device_used_mib()
    t0 = time.perf_counter()
    router = FabricRouter(spawn, runtime=prt, pods=2, min_pods=2,
                          wall_clock=True, fleet="proc")
    used = {"booted": _device_used_mib()}
    opens = {}
    try:
        reqs = trace()
        router.submit(reqs)
        _reset_counts()
        t_run = time.perf_counter()
        kill_wall = []

        def sigkill(m):
            used["mid-decode"] = _device_used_mib()
            opens.update({pid: _opens_card(pid) for _, pid in boots.values()})
            log("fabric: (c) nvidia-smi compute apps (pid, MiB): "
                + _smi("--query-compute-apps=pid,used_memory")
                .replace("\n", "; "))
            kill_wall.append(time.time())
            os.kill(m.transport.pid, signal.SIGKILL)
        victim, inflight = _kill_mid_decode(router, sigkill)
        kill_tick = router.tick
        _drain_fleet(router)
        run_s = time.perf_counter() - t_run
        used["drained"] = _device_used_mib()
        opens.update({pid: _opens_card(pid) for _, pid in boots.values()
                      if pid not in opens})
        fab = router.status()["fabric"]
        in_parent = _launch_counts()
    finally:
        router.close()
    wall = time.perf_counter() - t0
    victim.transport.proc.wait(timeout=60)
    alive = [p for p, pr in procs.items() if pr.poll() is None]
    evict = [e for e in router.trace.events() if e.name == "evict"]
    buffers = load_fleet_spans(prt.root, fleet="proc")
    validate_span_log(buffers)
    closure = validate_fleet_closure(buffers)
    workers = {pid: (pod_id, s) for pod_id, (s, pid) in boots.items()}
    per_worker = {k: (v - used0) / 2 for k, v in used.items()}
    log(f"fabric: (c) proc SIGKILL: {sum(r.state == 'done' for r in reqs)}/"
        f"{len(reqs)} done, {sum(len(r.tokens) for r in reqs)} tokens; "
        f"killed {victim.pod_id} (pid {victim.transport.pid}) at tick "
        f"{kill_tick} with {len(inflight)} in flight; evictions "
        f"{fab['evictions']}, reroutes {fab['reroutes']}, spawned "
        f"{fab['spawned']}; kill to eviction "
        + (f"{evict[0].wall - kill_wall[0]:.3f} s" if evict and kill_wall
           and evict[0].wall else "not recorded")
        + f"; closure from {len(buffers)} span files {closure}; run "
        f"{run_s:.2f} s, arm {wall:.2f} s (boots included) [{card}]")
    log("fabric: (c) workers (pod, pid, spawn to ready read, device node "
        "open): " + "; ".join(
            f"{pod} {pid} {s:.2f} s {opens.get(pid)}"
            for pid, (pod, s) in sorted(workers.items(),
                                        key=lambda kv: kv[1][0]))
        + f"; card memory in use {used0} MiB before the fleet, "
        + ", ".join(f"{v} MiB {k}" for k, v in used.items())
        + " (two live workers each time): per worker "
        + ", ".join(f"{v:.0f} MiB {k}" for k, v in per_worker.items())
        + f"; the weights are {weights_mib:.0f} MiB [{card}]")
    diffs = _token_diffs(want, reqs)
    if diffs:
        failures.append("(proc) tokens differ from the oracle: "
                        + _margins(torch, rt, "f32", reqs, want, diffs))
    if not all(r.state == "done" and len(r.tokens) == 32 for r in reqs):
        failures.append("(proc) requests lost or short")
    if fab["evictions"] != 1 or fab["reroutes"] < 1:
        failures.append(f"(proc) evictions {fab['evictions']}, reroutes "
                        f"{fab['reroutes']}")
    if closure["routed"] != closure["closed"] or \
            closure["routed"] != len(reqs):
        failures.append(f"(proc) closure {closure}")
    if not all(opens.get(pid) for pid in workers) or \
            min(per_worker.values()) <= weights_mib:
        failures.append(f"(proc) a worker is not on the card with its "
                        f"weights: device node open {opens}, MiB per "
                        f"worker {per_worker}")
    if any(in_parent.values()):
        failures.append(f"(proc) the router's process launched {in_parent}")
    if alive:
        failures.append(f"(proc) workers still running: {alive}")
    val = subprocess.run(
        [sys.executable, "-m", "repro_torch.orchestrator.obs.validate",
         "--spans", str(prt.root)], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(SRC)})
    log(f"fabric: (c) validate --spans: {val.stdout.strip()} "
        f"{val.stderr.strip()}")
    if val.returncode != 0:
        failures.append(f"(proc) validate --spans exited {val.returncode}")

    # (d) the entry point: serve --fabric proc, then ps and top
    root = workdir / "fabric-cli"
    root.mkdir()
    imagefile = root / "Imagefile"
    imagefile.write_text(FULL_IMAGEFILE.format(arch=arch))
    outs = []
    real_main = serve_mod.main

    def serve_main(argv=None):
        outs.append(real_main(argv))
        return outs[-1]

    def run(*argv):
        log(f"fabric: stevedore {' '.join(argv)}")
        return cli.main(["--root", str(root / "rt"), *argv])

    serve_mod.main = serve_main
    try:
        t0 = time.perf_counter()
        rc = run("serve", str(imagefile), *CLI_FABRIC)
        wall = time.perf_counter() - t0
    finally:
        serve_mod.main = real_main
    check(rc == 0 and outs, f"fabric: (d) serve exited {rc}")
    out = outs[0]
    budgets = serve_mod._tail_budgets(_flag(CLI_FABRIC, "--gen"),
                                      _flag(CLI_FABRIC, "--requests"))
    got = [len(out["request_tokens"].get(i, [])) for i in range(len(budgets))]
    log(f"fabric: (d) serve --fabric proc: {out['requests']} requests, "
        f"{out['tokens']} tokens (budgets {sorted(set(budgets))}), "
        f"evictions {out['evictions']}, reroutes {out['reroutes']}, closure "
        f"{out['fleet_closure']}; serve {out['wall_s']:.2f} s, command "
        f"{wall:.2f} s (boots included) [{card}]")
    if got != budgets or out["fleet_closure"]["closed"] != len(budgets):
        failures.append(f"(cli) tokens per request {got} != budgets "
                        f"{budgets}")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc_ps = run("ps")
    ps = buf.getvalue()
    log(ps.rstrip())
    fleet = [ln for ln in ps.splitlines() if ln.startswith("fabric-")]
    if rc_ps != 0 or len(fleet) != 1 or "live=" not in fleet[0]:
        failures.append(f"(cli) ps exited {rc_ps} without the fleet's live "
                        "count")
    if run("top") != 0:
        failures.append("(cli) top failed")
    check(not failures, "fabric: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# train: gradients through the kernels, smoke training card vs CPU, and
# full-width llama3.2-3b trained through the CLI
# ---------------------------------------------------------------------------

# (a) the Functions at the shapes training gives them: K2 at llama3.2-3b's
# (B, Hq, Hkv, S, d) and recurrentgemma-2b's local layers, bf16; K4 at
# recurrentgemma-2b's (B, S, R); K5 at mamba2-2.7b's (b, S, H, P, N) and
# chunk, float32
GRAD_K2 = ((2, 24, 8, 2048, 128, 0), (1, 10, 1, 2048, 256, 2048))
GRAD_K4 = (1, 2048, 2560)
GRAD_K5 = ((1, 1024, 80, 64, 128), 256)

# (b) smoke reductions trained 3 steps on the card and on the CPU, float32,
# TF32 off, the same weights and batches: each step's loss within 1e-3 and
# grad_norm within 1e-3 of its value (two devices sum in other orders, K2
# f32, K4 and K5 3xTF32 agree with their plain versions to 1e-6..1e-4 of
# their outputs, and routed MoE rows can flip at near-ties after a step)
TRAIN_SMOKE = ("llama3.2-3b-smoke", "mamba2-2.7b-smoke",
               "recurrentgemma-2b-smoke", "moonshot-v1-16b-a3b-smoke",
               "musicgen-medium-smoke")
TRAIN_SMOKE_KERNELS = {"llama3.2-3b-smoke": ("flash_attention_fwd",),
                       "mamba2-2.7b-smoke": ("ssd",),
                       "recurrentgemma-2b-smoke": ("rglru_scan",
                                                   "flash_attention_fwd"),
                       "moonshot-v1-16b-a3b-smoke": ("flash_attention_fwd",),
                       "musicgen-medium-smoke": ("flash_attention_fwd",)}
TRAIN_SMOKE_IMAGEFILE = """\
FROM scratch
ARCH {arch}
SHAPE train_4k seq_len=64 global_batch=4
MESH local
PRECISION compute=float32 params=float32
COLLECTIVES generic
SET optimizer={{"lr":0.005,"warmup_steps":2,"total_steps":50}}
"""
TRAIN_SMOKE_TOL = 1e-3

# (c) llama3.2-3b at full width through ``repro_torch.cli run``, cut to 8
# of its 28 layers: at full depth the phase took 161 s of the script's
# 1200 s, 128 s of it in three 38.5 GB checkpoint writes and reads
TRAIN_LAYERS = 8
TRAIN_IMAGEFILE = f"""\
FROM scratch
ARCH llama3.2-3b n_layers={TRAIN_LAYERS}
SHAPE train_4k seq_len=2048 global_batch=2
MESH local
PRECISION params=float32 compute=bfloat16
COLLECTIVES generic
SET remat=full optimizer={{"lr":0.0003,"warmup_steps":2,"total_steps":1000}}
"""
# 2 steps and the run's closing checkpoint, then a resume of 1 step (each
# 14.4 GB checkpoint write or read costs 10-20 s of the script's time; the
# periodic cadence is the CPU tests')
TRAIN_RUN = ("--steps", "2", "--keep", "1")
TRAIN_RESUME = ("--resume", "--steps", "1", "--keep", "1")
TRAIN_STRAIGHT = 3          # the straight run's steps: the resumed one last
# the resumed step 3 against a straight run's step 3: the same state and
# batch on the same card; bf16 products and atomics in the embedding's
# backward may sum in another order
TRAIN_RESUME_TOL = 1e-3


@contextmanager
def _no_plain(*modules):
    """The named plain versions raise while the block runs: a Function's
    forward and backward on the card must run its kernels alone."""
    saved = [(m, n, getattr(m, n)) for m, n in modules]

    def plain(*a, **kw):
        raise AssertionError("a plain version ran on the card's route")
    for m, n, _ in saved:
        setattr(m, n, plain)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _grad_case(torch, timer, state, name, fn, plain, inputs, cot, tol,
               rel: bool, bound: tuple, bwd: dict):
    """``fn`` (a Function) against ``plain`` under autograd on the card:
    output and every input's grad within ``tol`` (of the reference's max
    when ``rel``); ``fn``'s forward and backward run with the plain
    versions ``bwd["plain"]`` made to raise (its kernels only); times of
    the forward and of the backward (``bwd["what"]``), beside the
    forward's ``bound`` and the backward's ``bwd["bound"]`` (ms, by).
    Returns (ok, forward ms, backward ms)."""
    xs = [t.detach().requires_grad_() for t in inputs]
    rs = [t.detach().requires_grad_() for t in inputs]
    with _no_plain(*bwd["plain"]):
        out = fn(*xs)
        gx = torch.autograd.grad(out, xs, cot, retain_graph=True)
    ref = plain(*rs)
    gr = torch.autograd.grad(ref, rs, cot)
    torch.cuda.synchronize()
    errs = []
    ok = bool(torch.isfinite(out).all())
    for a, b in ((out.detach(), ref.detach()), *zip(gx, gr)):
        err = float((a.float() - b.float()).abs().max())
        lim = tol * (float(b.float().abs().max()) if rel else 1.0)
        ok = ok and err <= lim
        errs.append(f"{err:.2e}/{lim:.2e}")
    with torch.no_grad():
        fwd = timer(lambda: fn(*inputs))
    with _no_plain(*bwd["plain"]):
        bms = timer(lambda: torch.autograd.grad(out, xs, cot,
                                                retain_graph=True))
    log(f"train: {name}: max_abs_err out, grads (err/tol) "
        f"{', '.join(errs)} {'ok' if ok else 'FAIL'}; forward {fwd:.4f} ms "
        f"(bound {bound[0]:.4f} ms, {bound[1]}), backward ({bwd['what']}) "
        f"{bms:.4f} ms (bound {bwd['bound'][0]:.4f} ms, {bwd['bound'][1]}) "
        f"[{state['card']}]")
    return ok, fwd, bms


def k2_bwd_bound(B, Hq, Hkv, d, Sq, Sk, window, isz, dtype):
    """K2's backward's bound from its ``cost_bwd()``: q, k, v, out and dO
    read, dq, dk and dv written, L and D in float32; 10 flops a (q, k)
    pair inside the causal window per head dim."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.analysis import bound_ms
    flops, nbytes = fa_ops.cost_bwd(B, Hq, Hkv, Sq, Sk, d, isz,
                                    window=window)
    return bound_ms(nbytes, flops, dtype)


def _k2_grad_case(torch, timer, state, name, inputs, cot, window):
    """K2's Function on the card with its plain versions made to raise
    (forward and backward kernels only): the output within TOL of the
    plain forward, the grads within K2_BWD_TOL of the largest gradient of
    the dense float32 plain backward, two backward calls the same bits;
    the forward's time, the backward kernels' (one wrapper call on the
    forward kernel's out and L) beside their bound, the plain backward's.
    The backward's route must be the one ``k2_bwd_route`` requires.
    Returns (ok, forward ms, backward dict)."""
    from repro_torch.kernels._launch import device_sms
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref,
        flash_attention_ref)
    B, Hq, S, d = inputs[0].shape
    Hkv = inputs[1].shape[1]
    kw = dict(causal=True, window=window)
    plain = tuple((fa_ops, n) for n in ("flash_attention_ref",
                                        "_out_lse_ref",
                                        "flash_attention_bwd_ref"))
    xs = [t.detach().requires_grad_() for t in inputs]
    with _no_plain(*plain):
        out = fa_ops.flash_attention(*xs, **kw)
        gx = torch.autograd.grad(out, xs, cot, retain_graph=True)
        gx2 = torch.autograd.grad(out, xs, cot, retain_graph=True)
    same = all(torch.equal(a, b) for a, b in zip(gx, gx2))
    torch.cuda.synchronize()
    ref = flash_attention_ref(*inputs, **kw)
    out_err = float((out.detach().float() - ref.float()).abs().max())
    del ref
    f = [t.float() for t in inputs]
    want = flash_attention_bwd_ref(
        *f, flash_attention_ref(*f, **kw),
        flash_attention_lse_ref(*f[:2], **kw), cot.float(), **kw)
    errs, lims = [], []
    for a, b in zip(gx, want):
        errs.append(float((a.float() - b).abs().max()))
        lims.append(K2_BWD_TOL["bfloat16"] * float(b.abs().max()))
    del want, f
    route, route_ok = k2_bwd_route(torch, "bfloat16", d)
    ok = (bool(torch.isfinite(out).all()) and out_err <= TOL["bfloat16"]
          and same and route_ok and all(e <= l for e, l in zip(errs, lims)))
    with torch.no_grad():
        fwd = timer(lambda: fa_ops.flash_attention(*inputs, **kw))
        o, lse = fa_ops.flash_attention_fwd_cuda(*inputs, lse=True, **kw)
        ms = timer(lambda: fa_ops.flash_attention_bwd_cuda(
            *inputs, o, lse, cot, **kw))
        plain_ms = timer(lambda: flash_attention_bwd_ref(
            *inputs, o, lse, cot, **kw))
    del o, lse, out, gx, gx2, xs
    bwd_bound = k2_bwd_bound(B, Hq, Hkv, d, S, S, window, 2, "bfloat16")
    fwd_bound = k2_bound(B, Hq, Hkv, d, S, S, window, 2, "bfloat16")
    parts = fa_ops.group_splits(B, Hkv, S, Hq // Hkv,
                                fa_ops.bwd_key_block(torch.bfloat16, d),
                                device_sms(inputs[0].device))
    log(f"train: {name}: max_abs_err out {out_err:.2e} (tol "
        f"{TOL['bfloat16']:g}), grads dq, dk, dv vs the dense float32 "
        f"plain backward (err/tol) "
        f"{', '.join(f'{e:.2e}/{l:.2e}' for e, l in zip(errs, lims))}; "
        f"two backward calls the same bits {same} "
        f"{'ok' if ok else 'FAIL'}; forward {fwd:.4f} ms (bound "
        f"{fwd_bound[0]:.4f} ms, {fwd_bound[1]}), backward kernels "
        f"{ms:.4f} ms (route {route}"
        f"{'' if route_ok else ', not the required wgmma'}; bound "
        f"{bwd_bound[0]:.4f} ms, {bwd_bound[1]}; the group in {parts} "
        f"part(s)), plain backward {plain_ms:.4f} ms [{state['card']}]")
    return ok, fwd, dict(ms=ms, plain_ms=plain_ms, max_abs_err=max(errs))


def _train_grads(torch, state, timer) -> list[str]:
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import _ssd_chunked
    from repro_torch.launch.analysis import bound_ms

    failures = []
    rng = np.random.default_rng(21)
    cuda = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to("cuda", dt)
    bf = torch.bfloat16
    for B, Hq, Hkv, S, d, w in GRAD_K2:
        q = cuda(rng.standard_normal((B, Hq, S, d)), bf)
        k = cuda(rng.standard_normal((B, Hkv, S, d)), bf)
        v = cuda(rng.standard_normal((B, Hkv, S, d)), bf)
        cot = cuda(rng.standard_normal((B, Hq, S, d)), bf)
        name = (f"flash_attention B={B} Hq={Hq} Hkv={Hkv} S={S} d={d} "
                f"window={w} bfloat16")
        ok, fwd, bwd = _k2_grad_case(torch, timer, state, name, (q, k, v),
                                     cot, w)
        # the library's fused attention, forward and backward, as yardstick
        kr, vr = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
        if w:
            i = torch.arange(S, device="cuda")
            mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - w)
            sdpa = lambda *x: F.scaled_dot_product_attention(  # noqa: E731
                *x, attn_mask=mask)
        else:
            sdpa = lambda *x: F.scaled_dot_product_attention(  # noqa: E731
                *x, is_causal=True)
        with torch.no_grad():
            lib_fwd = timer(lambda: sdpa(q, kr, vr))
        xs = [t.detach().requires_grad_() for t in (q, kr, vr)]
        o = sdpa(*xs)
        lib_bwd = timer(lambda: torch.autograd.grad(o, xs, cot,
                                                    retain_graph=True))
        log(f"train: {name}: SDPA forward {lib_fwd:.4f} ms, backward "
            f"{lib_bwd:.4f} ms (library, not used by the port) "
            f"[{state['card']}]")
        bwd_bound = k2_bwd_bound(B, Hq, Hkv, d, S, S, w, 2, "bfloat16")
        state["train"][f"K2 {B}x{Hq}/{Hkv}x{S}x{d} w{w}"] = dict(
            fwd_ms=fwd, bwd_ms=bwd["ms"], plain_bwd_ms=bwd["plain_ms"],
            sdpa_fwd_ms=lib_fwd, sdpa_bwd_ms=lib_bwd,
            bound_ms=k2_bound(B, Hq, Hkv, d, S, S, w, 2, "bfloat16")[0],
            bwd_bound_ms=bwd_bound[0], bwd_max_abs_err=bwd["max_abs_err"])
        if "flash_attention_bwd" not in state["records"]:
            state["records"]["flash_attention_bwd"] = dict(
                max_abs_err=bwd["max_abs_err"], ms=bwd["ms"],
                plain_ms=bwd["plain_ms"], bound_ms=bwd_bound[0],
                bound_by=bwd_bound[1], library_ms=lib_bwd)
        if not ok:
            failures.append(name)
        del q, k, v, kr, vr, xs, o
        torch.cuda.empty_cache()

    a = cuda(1.0 / (1.0 + np.exp(-rng.standard_normal(GRAD_K4))))
    b = cuda(rng.standard_normal(GRAD_K4))
    cot = cuda(rng.standard_normal(GRAD_K4))
    name = "rglru_scan B={} S={} R={} float32".format(*GRAD_K4)
    k4_bound = bound_ms(*reversed(rg_ops.cost(*GRAD_K4)), "float32")
    # the backward: one reverse launch of K4 and the two products (bound:
    # a, h and the cotangent read, da and db written)
    k4_bwd_bound = bound_ms(*reversed(rg_ops.cost_bwd(*GRAD_K4)), "float32")
    ok, fwd, bwd = _grad_case(
        torch, timer, state, name, rg_ops.rglru_scan, rglru_scan_ref, (a, b),
        cot, RGLRU_TOL, rel=True, bound=k4_bound,
        bwd=dict(bound=k4_bwd_bound, what="kernel, reverse scan",
                 plain=((rg_ops, "rglru_scan_ref"),)))
    state["train"]["K4 {}x{}x{}".format(*GRAD_K4)] = dict(
        fwd_ms=fwd, bwd_ms=bwd, bwd_bound_ms=k4_bwd_bound[0])
    if not ok:
        failures.append(name)

    (bsz, S, H, P, N), Q = GRAD_K5
    x = cuda(rng.standard_normal((bsz, S, H, P)))
    dt = cuda(np.log1p(np.exp(rng.standard_normal((bsz, S, H)) - 1.0)))
    A = cuda(-np.exp(0.5 * rng.standard_normal(H)))
    Bm = cuda(rng.standard_normal((bsz, S, N)))
    Cm = cuda(rng.standard_normal((bsz, S, N)))
    cot = cuda(rng.standard_normal((bsz, S, H, P)))
    name = f"ssd b={bsz} S={S} H={H} P={P} N={N} chunk={Q} float32 (y)"
    k5_bound = bound_ms(*reversed(ssd_ops.cost(bsz, S, H, P, N, Q)),
                        "float32")
    # the backward's bound: twice the chunked forward's products (a grad
    # for each operand) at the f32 FMA rate
    k5_bwd_bound = bound_ms(*reversed(ssd_ops.cost_bwd(bsz, S, H, P, N, Q)),
                            "float32")
    ok, fwd, bwd = _grad_case(
        torch, timer, state, name,
        lambda *t: ssd_ops.ssd(*t, Q)[0],
        lambda *t: _ssd_chunked(*t, Q)[0], (x, dt, A, Bm, Cm), cot,
        SSD_REL_TOL, rel=True, bound=k5_bound,
        bwd=dict(bound=k5_bwd_bound, what="kernels",
                 plain=((ssd_ops, "_ssd_chunked"),
                        (ssd_ops, "ssd_bwd_ref"))))

    # the backward before K5's kernels: the chunked version recomputed
    # under autograd and its vjp
    def plain_vjp():
        rs = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        with torch.enable_grad():
            y, _ = _ssd_chunked(*rs, Q)
        return torch.autograd.grad(y, rs, cot)
    vjp_ms = timer(plain_vjp)
    log(f"train: {name}: backward kernels {bwd:.4f} ms, the plain vjp "
        f"(recomputed chunked version and its autograd) {vjp_ms:.4f} ms, "
        f"bound {k5_bwd_bound[0]:.4f} ms ({k5_bwd_bound[1]}) "
        f"[{state['card']}]")
    state["train"][f"K5 {bsz}x{S}x{H}x{P}x{N} c{Q}"] = dict(
        fwd_ms=fwd, bwd_ms=bwd, plain_vjp_ms=vjp_ms,
        bwd_bound_ms=k5_bwd_bound[0])
    if not ok:
        failures.append(name)
    return failures


def _train_smoke(torch, state, workdir: Path) -> list[str]:
    import numpy as np
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    rt = Runtime(workdir / "train_smoke")
    failures = []
    # on the card K2's backward runs its kernels alone, once a step per
    # attention layer, K4's its reverse scan, once a step per rec layer,
    # and K5's its kernels, once a step per ssm layer
    no_plain = ((rg_ops, "rglru_scan_ref"), (fa_ops, "flash_attention_ref"),
                (fa_ops, "_out_lse_ref"),
                (fa_ops, "flash_attention_bwd_ref"),
                (ssd_ops, "_ssd_chunked"), (ssd_ops, "ssd_bwd_ref"))
    for arch in TRAIN_SMOKE:
        rt.build(TRAIN_SMOKE_IMAGEFILE.format(arch=arch), tag=arch)
        weights = rt.run(arch, platform="cpu").init_params(0)
        runs = {}
        for platform in ("cuda", "cpu"):
            c = rt.run(arch, platform=None if platform == "cuda" else "cpu")
            params = c.load_params(weights)
            opt = c.init_opt_state(params)
            step = c.train_step_fn()
            data = SyntheticLM(DataConfig(
                vocab_size=c.arch.vocab_size, seq_len=c.cell.seq_len,
                global_batch=c.cell.global_batch, seed=0,
                frontend_len=c.arch.frontend_len, d_model=c.arch.d_model))
            before = _launch_counts()
            rec = []
            with _no_plain(*no_plain) if platform == "cuda" else nullcontext():
                for i in range(3):
                    params, opt, m = step(params, opt, data.batch(i))
                    rec.append((float(m["loss"]), float(m["grad_norm"])))
            after = _launch_counts()
            used = {k: after[k] - before[k] for k in after}
            runs[platform] = rec
            want = TRAIN_SMOKE_KERNELS[arch]
            kinds = c.arch.layer_types()
            want_bwd = {"rglru_scan_bwd": 3 * kinds.count("rec"),
                        "flash_attention_bwd": 3 * sum(
                            k in ("attn", "moe") for k in kinds),
                        "ssd_bwd": 3 * kinds.count("ssm")}
            if platform == "cuda" and not all(used[k] for k in want):
                failures.append(f"{arch}: the card run skipped {want}: "
                                f"{used}")
            if platform == "cuda" and any(used[k] != n
                                          for k, n in want_bwd.items()):
                failures.append(f"{arch}: the card run's backward launches "
                                f"{used}, expected {want_bwd}")
            if platform == "cpu" and any(used.values()):
                failures.append(f"{arch}: the CPU run launched {used}")
        dl = max(abs(a[0] - b[0]) for a, b in zip(runs["cuda"], runs["cpu"]))
        dg = max(abs(a[1] - b[1]) / b[1]
                 for a, b in zip(runs["cuda"], runs["cpu"]))
        ok = (all(np.isfinite(v) for r in runs.values() for p in r for v in p)
              and dl <= TRAIN_SMOKE_TOL and dg <= TRAIN_SMOKE_TOL)
        log(f"train: {arch} 3 steps card vs CPU (float32), backward "
            f"launches on the card {want_bwd} (K2's and K5's backward "
            f"kernels and K4's reverse scan alone): "
            f"losses "
            f"{[round(l, 6) for l, _ in runs['cuda']]} / "
            f"{[round(l, 6) for l, _ in runs['cpu']]}, max |dloss| {dl:.2e}, "
            f"max grad_norm rel diff {dg:.2e} (tol {TRAIN_SMOKE_TOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{arch}: card and CPU training disagree")
    return failures


def _train_flops(cfg, tokens: int, S: int) -> float:
    """Model FLOPs of one step (forward and backward, recompute not
    counted): 6 per parameter and token, plus attention's 12 L S d_attn
    per token (the PaLM count)."""
    from repro_torch.models.params import count_params
    from repro_torch.models.transformer import Model
    n = count_params(Model(cfg).param_defs())
    d_attn = cfg.n_heads * cfg.head_dim
    return tokens * (6.0 * n + 12.0 * cfg.n_layers * S * d_attn)


def _train_cli(torch, state, workdir: Path) -> list[str]:
    import numpy as np
    from repro_torch import cli
    from repro_torch.configs import get_config, get_shape_cell
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.analysis import PEAK_FLOPS

    failures = []
    root = workdir / "train"
    root.mkdir()
    imagefile = root / "Imagefile"
    imagefile.write_text(TRAIN_IMAGEFILE)
    cfg = get_config("llama3.2-3b", n_layers=TRAIN_LAYERS)
    outs = []
    real_main = train_mod.main

    def train_main(argv=None):
        outs.append(real_main(argv))
        return outs[-1]

    def run(*argv):
        log(f"train: stevedore {' '.join(argv)}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--root", str(root / "rt"), *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _main_path_counts(state)
        check(rc == 0, f"train: {argv[0]} exited {rc}")
        return counts, torch.cuda.max_memory_allocated(), wall

    run("build", "-t", "train", str(imagefile))
    train_mod.main = train_main
    try:
        counts, peak, wall = run("run", "train", *TRAIN_RUN)
        first = outs[-1]
        counts2, peak2, wall2 = run("run", "train", *TRAIN_RESUME)
        resumed = outs[-1]
    finally:
        train_mod.main = real_main
    cell = get_shape_cell("train_4k").scaled(seq_len=2048, global_batch=2)
    tokens = cell.seq_len * cell.global_batch
    for out, cnt, pk, wl, argv in ((first, counts, peak, wall, TRAIN_RUN),
                                   (resumed, counts2, peak2, wall2,
                                    TRAIN_RESUME)):
        steps = _flag(list(argv), "--steps")
        recs = [json.loads(ln) for ln in (Path(out["overlay"])
                / "metrics.jsonl").read_text().splitlines()]
        secs = [r["step_seconds"] for r in recs]
        med = statistics.median(secs[1:]) if len(secs) > 1 else secs[0]
        flops = _train_flops(cfg, tokens, cell.seq_len)
        want = {"flash_attention_fwd": cfg.n_layers * 2 * steps,
                "flash_attention_bwd": cfg.n_layers * steps}
        log(f"train: llama3.2-3b run {' '.join(argv)}: steps "
            f"{out['start_step'] + 1}..{out['steps']}, losses "
            f"{[round(out['losses'][s], 5) for s in sorted(out['losses'])]}; "
            f"step seconds {[round(t, 4) for t in secs]}, median after the "
            f"first {med:.4f} s = {tokens / med:.1f} tokens/s, model FLOPs "
            f"{flops / 1e12:.1f} T a step = "
            f"{100 * flops / med / PEAK_FLOPS['bfloat16']:.1f}"
            f"% of 989 TFLOP/s; peak memory {pk / 2**30:.2f} GiB; "
            f"{wl:.1f} s with checkpoints; launches {cnt}, expected {want} "
            f"[{state['card']}]")
        state["train"][f"llama run {' '.join(argv)}"] = dict(
            step_s=med, tokens_per_s=tokens / med, peak_gib=pk / 2**30,
            mfu=flops / med / PEAK_FLOPS["bfloat16"], wall_s=wl)
        if not all(np.isfinite(v) for v in out["losses"].values()):
            failures.append(f"run {argv}: a loss is not finite")
        if pk >= 80e9:
            failures.append(f"run {argv}: peak memory {pk / 1e9:.1f} GB")
        for name, n in cnt.items():
            if n != want.get(name, 0):
                failures.append(f"run {argv}: {name} launches {n} != "
                                f"{want.get(name, 0)}")
    n_first = _flag(list(TRAIN_RUN), "--steps")
    if resumed["start_step"] != n_first:
        failures.append(f"the resumed run started at step "
                        f"{resumed['start_step']}, not {n_first}")

    # a straight run through Container.train_step_fn, in process: its last
    # step against the resumed run's
    from repro_torch.core.runtime import Runtime
    torch.cuda.empty_cache()
    rt = Runtime(root / "rt")
    c = rt.run("train")
    params = c.init_params(0)
    opt = c.init_opt_state(params)
    step = c.train_step_fn(donate=True)
    data = SyntheticLM(DataConfig(vocab_size=c.arch.vocab_size,
                                  seq_len=c.cell.seq_len,
                                  global_batch=c.cell.global_batch, seed=0))
    straight = {}
    for i in range(TRAIN_STRAIGHT):
        params, opt, m = step(params, opt, data.batch(i))
        straight[i + 1] = float(m["loss"])
    del params, opt, m
    torch.cuda.empty_cache()
    last = TRAIN_STRAIGHT
    d_last = abs(straight[last] - resumed["losses"][last])
    d_first = max(abs(straight[s] - first["losses"][s])
                  for s in range(1, n_first + 1))
    ok = d_last <= TRAIN_RESUME_TOL
    log(f"train: straight {last}-step run (Container.train_step_fn): "
        f"losses {[round(straight[s], 5) for s in range(1, last + 1)]}; "
        f"step {last} resumed {resumed['losses'][last]:.6f} vs straight "
        f"{straight[last]:.6f}: |diff| {d_last:.2e} (tol "
        f"{TRAIN_RESUME_TOL:g}) {'ok' if ok else 'FAIL'}; steps "
        f"1-{n_first} against the first run: max |diff| {d_first:.2e}")
    if not ok:
        failures.append(f"resumed step {last} differs by {d_last:.2e}")
    return failures


def phase_train(torch, state, timer, workdir: Path) -> None:
    state["train"] = {}
    failures = _train_grads(torch, state, timer)
    torch.cuda.empty_cache()
    failures += _train_smoke(torch, state, workdir)
    torch.cuda.empty_cache()
    failures += _train_cli(torch, state, workdir)
    check(not failures, "train: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# dist: data-parallel training across processes (torchrun)
# ---------------------------------------------------------------------------

DIST_IMAGEFILE = """\
FROM scratch
ARCH {arch}{layers}
SHAPE train_4k seq_len=2048 global_batch=2
MESH local
PRECISION params=float32 compute=bfloat16
COLLECTIVES {collectives}
SET remat=full optimizer={{"lr":0.0003,"warmup_steps":2,"total_steps":1000}}
"""
# (a) one NCCL rank, llama3.2-3b at full width cut to (b)'s 2 layers (at
# full depth each run wrote a 38.5 GB checkpoint: 70 s a run), 2 steps an
# ABI: the losses of one process on the same image, weights and batches
# (the generic reference of (d), which the phase computes first) within
# 1e-6
DIST_A = {"generic": "generic", "host": "host"}
DIST_A_STEPS = 2
DIST_A_TOL = 1e-6
# (b) two gloo ranks sharing the card, depth cut to 2 of 28 layers (the
# phase's time: at low depth the 394 M-parameter embedding dominates each
# step's wire bytes, so 2 layers halve 8 layers' 9.59e9 a step a rank), 3
# steps an ABI, one row of the 2 x 2048 global batch a rank, against one
# process on the same global batch in DIST_B_MICROBATCHES microbatches of
# one row: the ranks' arithmetic (each row's bf16 gradient from its own
# backward, the two summed in float32), where the whole batch in one
# backward rounds each bf16 gradient product once over both rows and two
# Adam steps at the image's learning rate carry that rounding to 1.2e-3
# of a 2-layer model's loss (17.6 at step 2). Float32 wires: loss within
# 1e-3, grad_norm within 1e-3 relative. The bf16 wire rounds every
# gradient to 8 bits of mantissa before the mean (2^-9 relative): 1e-2 on
# both.
DIST_B_LAYERS = 2
DIST_B_MICROBATCHES = 2
DIST_B = {"generic": ("generic", 1e-3), "host": ("host", 1e-3),
          "explicit": ("host mode=explicit", 1e-2)}
DIST_B_STEPS = 3
DIST_B_CKPT = 2             # host's checkpoint that (c) restores


def tp_wire_bytes(cfg, n_kv_orig: int, tokens: int, act_bytes: int,
                  remat: str = "none", param_bytes: int = 4) -> int:
    """The bytes one rank hands to the ``model`` axis's collectives in one
    training step (no microbatches), as ``CollectiveStats`` counts them
    (an all-reduce twice its tensor, an all-gather its output, a
    reduce-scatter its input), for ``tokens`` = the rank's rows x seq_len
    of ``cfg`` in a compute dtype of ``act_bytes``, params of
    ``param_bytes``:

    * the vocab-parallel embedding's exit, forward: (T, D);
    * each attention block: its output's exit forward (T, D), and
      backward the entries of the q projection's input (T, D) and of the
      k and v heads (T, n_kv_orig, hd) each;
    * each dense MLP (attention and ``rec`` blocks): its exit forward and
      its entry backward, (T, D) each; each MoE block instead: its exit
      forward (T, D), and backward the entries of its tokens (T, D) and
      of the routing weights (T, k) in float32;
    * each ``rec`` block: its region's exit forward and entry backward,
      (T, D) each;
    * each ``ssm`` block: its region's exit forward and entry backward,
      (T, D) each, B's and C's entries backward, (T, ssm_state) float32
      each;
      ``rms_gated``'s sum of squares, (T,) float32, forward and backward;
      the conv's whole rows (conv_w and conv_b, (d_inner + 2 ssm_state)
      x (conv_kernel + 1) params) gathered forward and reduce-scattered
      backward;
    * ``remat="full"``: when the backward recomputes a unit (one stacked
      layer: a block, or recurrentgemma's rec, rec, attn), everything in
      it up to the last tensor the backward needs runs again -- every
      exit of the unit but its last (torch.utils.checkpoint's early stop:
      the last exit only feeds the next unit's residual), ``rms_gated``'s
      forward sum and the conv rows' gathers;
    * the head's entry backward (T, D), and the vocab-parallel cross
      entropy's row max, sum of exponentials and gold logit forward, (T,)
      float32 each."""
    from repro_torch.models.transformer import build_stages
    T, D, hd = tokens, cfg.d_model, cfg.head_dim_
    td = 2 * T * D * act_bytes
    total = td + td + 3 * 2 * T * 4
    for st in build_stages(cfg):
        unit, exits, again = 0, [], 0       # entries, exits, recomputed
        for kind in st.unit:
            if kind == "ssm":
                conv = ((cfg.d_inner + 2 * cfg.ssm_state)
                        * (cfg.conv_kernel + 1) * param_bytes)
                rms = 2 * T * 4
                unit += (td + 2 * 2 * T * cfg.ssm_state * 4
                         + 2 * rms + 2 * conv)
                again += rms + conv
                exits.append(td)
                continue
            if kind == "rec":
                unit += td
            else:
                unit += td + 2 * 2 * T * n_kv_orig * hd * act_bytes
            unit += td + (2 * T * cfg.top_k * 4 if kind == "moe" else 0)
            exits += [td, td]
        unit += sum(exits)
        if remat == "full":
            unit += sum(exits[:-1]) + again
        total += st.count * unit
    return total


def fsdp_wire_bytes(cfg, replicas: int, tp: int = 1, remat: str = "none",
                    param_bytes: int = 4, microbatches: int = 1) -> int:
    """The bytes one rank hands to the ABI's collectives in one implicit
    training step under ``SET fsdp=true`` on a (``replicas``, ``tp``)
    (data, model) mesh, counted as ``CollectiveStats`` counts them.
    Every leaf (of the model bound to ``tp``) is the rank's model-axis
    shard (``tp_shard``: the leaf over the parts its model-axis dim
    splits into); FSDP splits it further when it has an ``embed`` dim
    that ``replicas`` divides. For such a leaf, whole over the batch axes
    (the shard, of ``param_bytes`` a param):

    * an all-gather where the model reads it (its output: the shard), a
      microbatch: once for the embedding and ``final_norm``, once for a
      layer's leaf at its unit's start and, with ``remat`` other than
      ``none``, again when the backward recomputes the unit (the gather
      is its first operation, so the recompute never stops before it);
    * the reduce-scatter of its float32 gradient in the backward (its
      input: the shard, 4 bytes a param), a microbatch;

    and for every other leaf the float32 all-reduce of its gradient once a
    step (twice the shard, 4 bytes a param). No all-gather follows the
    update: params stay parts."""
    from repro_torch.dist.mesh import PlatformMesh
    from repro_torch.dist.sharding import ShardingRules, def_shardings
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import Model
    defs = Model(cfg, tp=tp).param_defs()
    mesh = PlatformMesh(("data", "model"), (replicas, tp))
    rules = ShardingRules.default(fsdp=True)
    gathers_layer = 2 if remat != "none" else 1
    total = 0
    for name in sorted(defs):
        shs = tree_leaves(def_shardings(defs[name], mesh, rules))
        for d, sh in zip(tree_leaves(defs[name]), shs):
            shard = math.prod(sh.local_shape(d.shape, ("model",)))
            if not sh.split(("data",)):
                total += 2 * shard * 4
                continue
            gathers = gathers_layer if name.startswith("stage") else 1
            total += microbatches * shard * (gathers * param_bytes + 4)
    return total


def powersgd_wire_bytes(cfg, replicas: int, tp: int, rank: int) -> dict:
    """The bytes one rank hands to the ABI's collectives in one explicit
    PowerSGD step (``compression=powersgd rank=R``, float32) on a
    (``replicas``, ``tp``) (data, model) mesh, by axis, counted as
    ``CollectiveStats`` counts them (an all-reduce twice its tensor, an
    all-gather its output). Each leaf of the model bound to ``tp`` is the
    rank's model-axis shard; a leaf ``_compressible`` as a whole (m, n)
    matrix, split over the model axis on dim d, moves:

    * ``"model"`` (``tp`` > 1): with d = 0 (the rows) the all-gather of
      P (m x R) and the all-reduce of Qn (n x R); with d in the rest (the
      columns) the all-reduce of P (m x R) and the all-gather of Qn (n x
      R): (m + n) R floats on the wire, (m + 2n) R or (2m + n) R counted;
      with no such dim, nothing;
    * ``"batch"`` (``replicas`` > 1): the all-reduces of the rank's P and
      Qn: (m/tp + n) R with d = 0, (m + n/tp) R with d in the rest,
      (m + n) R unsplit;

    and every other leaf the all-reduce of its float32 shard over the
    batch axes. Over one replica the batch means are the identity."""
    from repro_torch.dist.mesh import PlatformMesh
    from repro_torch.dist.sharding import ShardingRules, def_shardings
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import Model
    from repro_torch.train.compression import _compressible
    defs = Model(cfg, tp=tp).param_defs()
    mesh = PlatformMesh(("data", "model"), (replicas, tp))
    out = {"model": 0, "batch": 0}
    for d, sh in zip(tree_leaves(defs),
                     tree_leaves(def_shardings(defs, mesh,
                                               ShardingRules.default()))):
        local = math.prod(sh.local_shape(d.shape))
        dims = [i for i, _ in sh.split_axes(("model",))]
        if not _compressible(d, rank):
            out["batch"] += 2 * local * 4 * (replicas > 1)
            continue
        m = d.shape[0]
        n = math.prod(d.shape) // m
        if not dims:
            out["batch"] += 2 * (m + n) * rank * 4 * (replicas > 1)
        elif dims[0] == 0:
            out["model"] += (m + 2 * n) * rank * 4
            out["batch"] += 2 * (m // tp + n) * rank * 4 * (replicas > 1)
        else:
            out["model"] += (2 * m + n) * rank * 4
            out["batch"] += 2 * (m + n // tp) * rank * 4 * (replicas > 1)
    return out


def powersgd_splits(cfg, tp: int, rank: int) -> dict:
    """The leaves of ``cfg``'s model bound to ``tp`` that PowerSGD at
    ``rank`` compresses (``_compressible`` as whole leaves), by path, each
    with the dim the ``model`` axis splits (``None``: not split): 0 takes
    ``powersgd_sync``'s rows branch, any other dim its columns branch --
    with the rank's Q rows strided where a stacked (L, D, F) leaf is split
    past its second dim."""
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.dist.mesh import PlatformMesh
    from repro_torch.dist.sharding import ShardingRules, def_shardings
    from repro_torch.train.compression import _compressible
    from repro_torch.models.transformer import Model
    defs = Model(cfg, tp=tp).param_defs()
    mesh = PlatformMesh(("data", "model"), (1, tp))
    shs = dict(_flatten(def_shardings(defs, mesh, ShardingRules.default())))
    out = {}
    for path, d in _flatten(defs):
        if _compressible(d, rank):
            dims = [i for i, _ in shs[path].split_axes(("model",))]
            out[path] = dims[0] if dims else None
    return out


def generic_wire_bytes(cfg, tp: int = 1) -> int:
    """The bytes one rank hands to the ``generic`` ABI's collectives in
    one implicit training step on a mesh with a ``model`` axis of ``tp``
    and more than one batch replica, as ``CollectiveStats`` counts them:
    the float32 all-reduce of its model-axis shard of every gradient
    (twice the shard, 4 bytes a param)."""
    from repro_torch.dist.mesh import PlatformMesh
    from repro_torch.dist.sharding import ShardingRules, def_shardings
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import Model
    defs = Model(cfg, tp=tp).param_defs()
    mesh = PlatformMesh(("data", "model"), (2, tp))
    shs = def_shardings(defs, mesh, ShardingRules.default())
    return sum(2 * math.prod(sh.local_shape(d.shape, ("model",))) * 4
               for d, sh in zip(tree_leaves(defs), tree_leaves(shs)))


def moe_count_bytes(cfg, replicas: int, recompute: bool = False,
                    microbatches: int = 1) -> int:
    """The bytes one rank hands to the MoE's global dispatch (label
    ``"moe"``) in one training step over ``replicas`` batch replicas, as
    ``CollectiveStats`` counts an all-gather (its output): each MoE
    layer's call gathers every replica's per-expert assignment counts,
    ``replicas`` x E int64, once a microbatch in the forward and once
    more where the backward recomputes the layer (``recompute``)."""
    layers = sum(k == "moe" for k in cfg.layer_types())
    return (replicas * cfg.n_experts * 8 * layers * microbatches
            * (2 if recompute else 1))


def _torchrun(nproc: int, root: Path, imagefile: Path, steps: int,
              extra=(), timeout: float = 900, watch=None) -> tuple:
    """``torchrun --nproc-per-node N -m repro_torch.cli run`` (as
    ``python -m torch.distributed.run``, the same program); ``watch``
    gets the ranks' pids twice a second while the job runs. Returns (exit
    code, output tail, the ranks' records from the overlay's ranks.json,
    seconds)."""
    rc, tail, wall = _torchrun_cmd(
        nproc, ["-m", "repro_torch.cli", "--root", str(root), "run",
                str(imagefile), "--steps", str(steps), *extra],
        root.parent, timeout, watch)
    found = sorted(root.glob("overlays/*/ranks.json"))
    ranks = json.loads(found[-1].read_text()) if found else []
    return rc, tail, ranks, wall


def _torchrun_cmd(nproc: int, program: list, cwd: Path,
                  timeout: float = 900, watch=None) -> tuple:
    """``python -m torch.distributed.run --standalone --nproc-per-node N``
    of ``program`` (a script and its arguments, or ``-m`` and a module)
    with the port on PYTHONPATH; ``watch`` gets the ranks' pids twice a
    second while the job runs. Returns (exit code, output tail,
    seconds)."""
    import os
    import threading
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")])}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *program]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=str(cwd),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    out = []
    reader = threading.Thread(
        target=lambda: out.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        while proc.poll() is None:
            if watch is not None:
                watch(_children(proc.pid))
            time.sleep(0.5)
            if time.perf_counter() - t0 > timeout:
                proc.kill()
        reader.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, "".join(out)[-4000:], time.perf_counter() - t0


def _children(pid: int) -> list[int]:
    """The direct children of ``pid`` (torchrun's rank processes)."""
    kids = []
    for task in Path(f"/proc/{pid}/task").glob("*/children"):
        try:
            kids += [int(k) for k in task.read_text().split()]
        except OSError:
            continue
    return kids


def _rank_summary(ranks: list) -> str:
    parts = []
    for r in ranks:
        steps = r["steps"]
        rest = steps[1:] or steps
        parts.append(
            f"rank {r['rank']}/{r['ranks']} {r['backend']} {r['device']}: "
            f"step s {[round(s['seconds'], 4) for s in steps]} (median "
            f"after the first {statistics.median(x['seconds'] for x in rest):.4f}"
            f"), collective s a step "
            f"{statistics.median(x['collective_seconds'] for x in rest):.4f}, "
            f"wire bytes a step {steps[-1]['wire_bytes']} "
            f"({r['wire_bytes_by_op']}), peak memory "
            f"{_gib(r['peak_memory_bytes']):.2f} GiB, K2 launches "
            f"{r['kernel_launches']['flash_attention_fwd']}, its backward's "
            f"{r['kernel_bwd_launches']['flash_attention_bwd']}")
    return "; ".join(parts)


def _gib(nbytes) -> float:
    """Bytes in GiB (nan where a rank ran off the card)."""
    return float("nan") if nbytes is None else nbytes / 2**30


def _rank_launches(r: dict) -> dict:
    """A launch/train rank's record's launches, forward and backward
    counters in one dict (as ``_launch_counts``)."""
    return {**r["kernel_launches"], **r["kernel_bwd_launches"]}


def _add_rank_launches(state, ranks: list) -> None:
    for r in ranks:
        for name, n in _rank_launches(r).items():
            state["launches"][name] = state["launches"].get(name, 0) + n


def _dist_reference(torch, workdir: Path, imagefile: str, steps: int,
                    drops: list | None = None):
    """One process on the card, the same image, weights and global
    batches as launch/train's ranks: per step (loss, grad_norm), and the
    run's peak memory; with ``drops`` the MoE assignments each step drops
    to capacity (its forward's and its recompute's) appended to it."""
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt = Runtime(workdir / "dist_ref")
    c = rt.run(rt.build(imagefile))
    params = c.init_params(0)
    opt = c.init_opt_state(params)
    step = c.train_step_fn(donate=True)
    data = SyntheticLM(DataConfig(vocab_size=c.arch.vocab_size,
                                  seq_len=c.cell.seq_len,
                                  global_batch=c.cell.global_batch, seed=0))
    rec = []
    for i in range(steps):
        calls: list = []
        with (_moe_drop_counter(calls) if drops is not None
              else nullcontext()):
            params, opt, m = step(params, opt, data.batch(i))
        rec.append((float(m["loss"]), float(m["grad_norm"])))
        if drops is not None:
            drops.append(sum(int((~k).sum()) for k in calls))
    peak = torch.cuda.max_memory_allocated()
    del params, opt, m
    torch.cuda.empty_cache()
    return rec, peak


def _dist_a(torch, state, workdir: Path, ref: list) -> list[str]:
    """One NCCL rank per ABI against ``ref``, one process's (loss,
    grad_norm) a step on the same image cut to DIST_B_LAYERS."""
    import shutil
    failures = []
    n_layers = DIST_B_LAYERS
    for name, coll in DIST_A.items():
        root = workdir / f"dist_a_{name}"
        root.mkdir()
        imagefile = root / "Imagefile"
        imagefile.write_text(DIST_IMAGEFILE.format(
            arch="llama3.2-3b", layers=f" n_layers={n_layers}",
            collectives=coll))
        torch.cuda.empty_cache()
        rc, tail, ranks, wall = _torchrun(1, root / "rt", imagefile,
                                          DIST_A_STEPS)
        shutil.rmtree(root)
        if rc != 0 or len(ranks) != 1:
            failures.append(f"(a) {name}: exit {rc}, {len(ranks)} rank "
                            f"records: {tail}")
            continue
        _add_rank_launches(state, ranks)
        r = ranks[0]
        losses = [s["loss"] for s in r["steps"]]
        want = [l for l, _ in ref[:len(losses)]]
        diff = max(abs(l - w) for l, w in zip(losses, want))
        k2 = (r["kernel_launches"]["flash_attention_fwd"],
              r["kernel_bwd_launches"]["flash_attention_bwd"])
        ok = (r["backend"] == "nccl" and diff <= DIST_A_TOL
              and len(want) == DIST_A_STEPS
              and k2 == (n_layers * 2 * DIST_A_STEPS, n_layers * DIST_A_STEPS))
        log(f"dist: (a) torchrun --nproc-per-node 1 cli run, llama3.2-3b "
            f"{n_layers} layers, {name}: losses "
            f"{[round(l, 6) for l in losses]} vs one process "
            f"{[round(w, 6) for w in want]}: max |diff| {diff:.2e} (tol "
            f"{DIST_A_TOL:g}); {_rank_summary(ranks)}; expected K2 "
            f"{n_layers} x 2 x {DIST_A_STEPS}, its backward {n_layers} x "
            f"{DIST_A_STEPS}; {wall:.1f} s with the "
            f"checkpoint {'ok' if ok else 'FAIL'} [{state['card']}]")
        state["dist"][f"a {name}"] = dict(
            step_s=[s["seconds"] for s in r["steps"]],
            peak_gib=_gib(r["peak_memory_bytes"]), wall_s=wall)
        if not ok:
            failures.append(f"(a) {name}: backend {r['backend']}, loss diff "
                            f"{diff:.2e}, K2 {k2}")
    return failures


def _dist_b(torch, state, workdir: Path) -> tuple[list[str], dict]:
    import shutil
    failures, host_steps, refs = [], {}, {}
    for name, (coll, tol) in DIST_B.items():
        root = workdir / f"dist_b_{name}"
        root.mkdir()
        imagefile = root / "Imagefile"
        text = DIST_IMAGEFILE.format(arch="llama3.2-3b",
                                     layers=f" n_layers={DIST_B_LAYERS}",
                                     collectives=coll)
        imagefile.write_text(text)
        # on one process ZeRO-1 splits nothing: host's step is generic's
        path = "explicit" if "explicit" in coll else "implicit"
        if path not in refs:
            refs[path] = _dist_reference(
                torch, workdir,
                text + f"SET microbatches={DIST_B_MICROBATCHES}\n",
                DIST_B_STEPS)[0]
        ref = refs[path]
        if path == "implicit":              # (e)'s reference
            state["dist_b_ref"] = ref
        seen: dict[int, bool] = {}
        used = [_device_used_mib()]

        def watch(pids):
            for pid in pids:
                if not seen.get(pid):
                    try:
                        seen[pid] = _opens_card(pid)
                    except OSError:     # gone, or not yet readable
                        continue
            used.append(_device_used_mib())

        extra = (("--ckpt-every", str(DIST_B_CKPT)) if name == "host"
                 else ())
        rc, tail, ranks, wall = _torchrun(2, root / "rt", imagefile,
                                          DIST_B_STEPS, extra, watch=watch)
        if rc != 0 or len(ranks) != 2:
            failures.append(f"(b) {name}: exit {rc}, {len(ranks)} rank "
                            f"records: {tail}")
            continue
        _add_rank_launches(state, ranks)
        state.setdefault("dist_b_peak", {})[name] = min(
            r["peak_memory_bytes"] for r in ranks)
        r0 = ranks[0]
        dl = max(abs(s["loss"] - l) for s, (l, _) in zip(r0["steps"], ref))
        dg = max(abs(s["grad_norm"] - g) / g
                 for s, (_, g) in zip(r0["steps"], ref))
        same = all(r["steps"][i]["loss"] == r0["steps"][i]["loss"]
                   for r in ranks for i in range(DIST_B_STEPS))
        k2 = [(r["kernel_launches"]["flash_attention_fwd"],
               r["kernel_bwd_launches"]["flash_attention_bwd"])
              for r in ranks]
        on_card = [seen.get(r["pid"], False) for r in ranks]
        ok = (dl <= tol and dg <= tol and same and all(on_card)
              and all(r["backend"] == "gloo" for r in ranks)
              and k2 == [(DIST_B_LAYERS * 2 * DIST_B_STEPS,
                          DIST_B_LAYERS * DIST_B_STEPS)] * 2)
        log(f"dist: (b) torchrun --nproc-per-node 2 cli run, llama3.2-3b "
            f"{DIST_B_LAYERS} layers, {coll}: losses "
            f"{[round(s['loss'], 6) for s in r0['steps']]} vs one process "
            f"{[round(l, 6) for l, _ in ref]}: max |dloss| {dl:.2e}, max "
            f"grad_norm rel diff {dg:.2e} (tol {tol:g}); every rank's loss "
            f"equal {same}; {_rank_summary(ranks)}; expected K2 "
            f"{DIST_B_LAYERS} x 2 x {DIST_B_STEPS}, its backward "
            f"{DIST_B_LAYERS} x {DIST_B_STEPS} a rank; ranks hold "
            f"/dev/nvidia* open {on_card}; card memory in use "
            f"{used[0]} MiB before, {max(used)} MiB at most during the "
            f"run; {wall:.1f} s with checkpoints {'ok' if ok else 'FAIL'} "
            f"[{state['card']}]")
        state["dist"][f"b {name}"] = dict(
            step_s=[[s["seconds"] for s in r["steps"]] for r in ranks],
            peak_gib=[_gib(r["peak_memory_bytes"]) for r in ranks],
            wire=r0["steps"][-1]["wire_bytes"], wall_s=wall)
        state["dist_ranks"][f"b {name}"] = dict(
            text=text, mesh=(2, 1), steps=DIST_B_STEPS,
            by_op=r0["wire_bytes_by_op"], launches=_rank_launches(r0))
        if name == "host":
            host_steps = {"root": root, "steps": r0["steps"], "tol": tol,
                          "text": text}
        else:
            shutil.rmtree(root)
        if not ok:
            failures.append(f"(b) {name}: dloss {dl:.2e}, dgnorm {dg:.2e}, "
                            f"equal {same}, K2 {k2}, on card {on_card}")
    return failures, host_steps


def _dist_c(torch, state, host: dict) -> list[str]:
    """Restore (b)'s host step-2 checkpoint (2 ranks, ZeRO-1) onto one
    process and take step 3."""
    import shutil
    from repro_torch.checkpoint.elastic import reshard_restore
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    if not host:
        return ["(c): no host run to restore"]
    rt = Runtime(host["root"] / "rt")
    c = rt.run(rt.build(host["text"]))
    store = CheckpointStore(next(host["root"].glob(
        "rt/overlays/*/ckpt/manifests")).parent)
    t = {"params": c.abstract_params(), "opt": c.abstract_opt_state()}
    sh = {"params": c.param_shardings(), "opt": c.opt_state_shardings()}
    restored = reshard_restore(store, t, sh, step=DIST_B_CKPT)
    params, opt = restored["params"], restored["opt"]
    data = SyntheticLM(DataConfig(vocab_size=c.arch.vocab_size,
                                  seq_len=c.cell.seq_len,
                                  global_batch=c.cell.global_batch, seed=0))
    step = c.train_step_fn(donate=True)
    _reset_counts()
    params, opt, m = step(params, opt, data.batch(DIST_B_CKPT))
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    counts = _main_path_counts(state)
    want = host["steps"][DIST_B_CKPT]
    dl = abs(loss - want["loss"])
    dg = abs(gnorm - want["grad_norm"]) / want["grad_norm"]
    ok = (int(opt["step"]) == DIST_B_CKPT + 1 and dl <= host["tol"]
          and dg <= host["tol"]
          and counts["flash_attention_fwd"] == DIST_B_LAYERS * 2
          and counts["flash_attention_bwd"] == DIST_B_LAYERS)
    log(f"dist: (c) the 2-rank host checkpoint of step {DIST_B_CKPT} "
        f"restored onto one process (reshard_restore: whole m/v from two "
        f"ZeRO-1 halves): step {DIST_B_CKPT + 1} loss {loss:.6f} vs (b)'s "
        f"{want['loss']:.6f}, |diff| {dl:.2e}, grad_norm rel diff "
        f"{dg:.2e} (tol {host['tol']:g}); launches {counts} "
        f"{'ok' if ok else 'FAIL'} [{state['card']}]")
    del params, opt, m, restored
    torch.cuda.empty_cache()
    shutil.rmtree(host["root"])
    return [] if ok else [f"(c): dloss {dl:.2e}, dgnorm {dg:.2e}, "
                          f"launches {counts}"]


# (d) tensor parallelism: two gloo ranks sharing the card on a (data 1,
# model 2) mesh, DIST_IMAGEFILE's settings (f32 params, bf16 compute,
# remat=full, both rows of the 2 x 2048 global batch on each rank) at
# full width cut in depth (moonshot: its dense first layer and one MoE
# layer of 32 experts a rank, the 2 shared experts split on F; mamba2:
# two ssm layers, 40 of 80 heads a rank; recurrentgemma: one rec, rec,
# attn cycle, 1280 of 2560 RG-LRU channels and 5 of 10 q heads over 1 of
# 1 kv head a rank), 3 steps under the generic ABI, against one process
# on the same global batch: loss and grad_norm within 1e-3 relative.
# (b)'s loss gate is 1e-3 absolute, where its ranks compute each row's
# forward as one process does (its step 1 is bit-equal); here each output
# projection sums two bf16 partials (two roundings more than one
# product), step 1's loss already differs by about 2e-5 of itself, and
# two Adam steps at this image's learning rate (the loss moves by 5
# between steps) carry it to about 1e-4 of the loss, 1.2-2e-3 absolute
# at losses of 12-17
DIST_D = {"llama3.2-3b": 2, "moonshot-v1-16b-a3b": 2, "mamba2-2.7b": 2,
          "recurrentgemma-2b": 3}
DIST_D_STEPS = 3
DIST_D_TOL = 1e-3
DIST_D_TOKENS = 2 * 2048            # a rank's rows x seq_len
# (e) weight FSDP: the same two ranks on a (data 2, model 1) mesh,
# llama3.2-3b at (b)'s depth, one 2048-token row a rank, 3 steps under
# two arms -- generic + fsdp (DIST_IMAGEFILE's remat=full) and the paper's
# Fig. 3 host arm (host + fsdp + remat=dots) -- against (b)'s one-process
# run in two one-row microbatches, within (b)'s bounds (1e-3)
DIST_E = {"generic": ("generic", "full"), "host": ("host", "dots")}
# (f) serving on the model axis: the same two ranks run a port Pod on their
# (data 1, model 2) mesh with a ContinuousScheduler over the same
# requests, in float32 compute and params: llama3.2-3b at full width and
# full depth (28 layers; 12 of 24 q heads over 4 of 8 kv heads a rank),
# paged (page 16, 8 slots of 1024, prefix cache) on 8 of the serve
# phase's requests (four of 64-512 tokens, four sharing its 256-token
# prefix), 32 new tokens each, decode chunk 4 -- its tokens held to one
# float32 process's Pod on the same requests; then recurrentgemma-2b cut
# to one (rec, rec, attn) cycle and mamba2-2.7b cut to 2 layers,
# contiguous, on 4 prompts each (mamba2's multiples of its 256-step
# chunk), 32 new tokens: their prefills launch K4 and K5 on the serving
# path. Each entry: (layers or None for the arch's own, Pod keywords,
# kernel -> (per "prefill" dispatch | "decode" step, launches), prompt
# lengths or None for the serve phase's)
POD_TP_IMAGEFILE = """\
FROM scratch
ARCH {arch}{layers}
MESH local
PRECISION compute=float32 params=float32
"""
POD_TP = {
    "llama3.2-3b": (None, dict(n_slots=8, max_len=1024, paged=True,
                               page_size=16, prefix_cache=True),
                    {"paged_attention": ("decode", 28),
                     "flash_attention_fwd": ("prefill", 28)}, None),
    "recurrentgemma-2b": (3, dict(n_slots=4, max_len=1024),
                          {"rglru_scan": ("prefill", 2),
                           "flash_attention_fwd": ("prefill", 1)},
                          (64, 512, 64, 512)),
    "mamba2-2.7b": (2, dict(n_slots=4, max_len=1024), {"ssd": ("prefill", 2)},
                    (256, 512, 256, 512)),
}
POD_TP_NEW = 32
# (g) PowerSGD on the model axis: the same two ranks on a (data 1, model
# 2) mesh, llama3.2-3b at full width cut to 6 layers, both 2048-token rows
# on each rank, 3 steps of ``host mode=explicit`` with float32 means and
# rank-1 PowerSGD, against one process's PowerSGD steps at model 1 on the
# same global batch from the same initial Q (the same draws): loss and
# grad_norm within 1e-3 relative, the model axis's PowerSGD bytes a step
# = ``powersgd_wire_bytes``. A stacked (L, D, F) leaf is compressible
# where L > 4 x rank: at 6 layers and rank 1 every stacked matrix is, so
# both of ``powersgd_sync``'s splits run -- the embedding's rows, and the
# columns of the layers' projections, strided Q rows for those split on F
DIST_G = ("host mode=explicit grad_compression=float32 "
          "compression=powersgd rank=1")
DIST_G_RANK = 1
DIST_G_LAYERS = 6
# (g) runs its model in float32 compute: three Adam steps on rank-1
# PowerSGD gradients carry the last bits of each step's products into
# step 3, and in bf16 compute the backward's rounding (2^-9 a product)
# moves the step-3 grad norm by about its 1e-3 bound, whichever backward
# computes it; in float32 (TF32 off) both sides round at 2^-24, and what
# (g) holds -- powersgd_sync compressing each leaf's whole matrix from the
# model axis's shards as one process does -- is float32 arithmetic
# already (grad_compression=float32)


def _dist_g_image() -> str:
    """(g)'s image: DIST_IMAGEFILE at 6 layers under DIST_G, in float32
    compute."""
    return DIST_IMAGEFILE.format(
        arch="llama3.2-3b", layers=f" n_layers={DIST_G_LAYERS}",
        collectives=DIST_G).replace("compute=bfloat16", "compute=float32")
# (h) the MoE over data replicas: a (data 2, model 1) mesh, generic,
# moonshot-v1-16b-a3b at full width cut to (d)'s dense layer and one MoE
# layer (64 experts whole on each rank), one 2048-token row a rank, 3
# steps, against (d)'s one process on both rows in ONE microbatch (the
# global capacity makes two microbatches another computation): loss and
# grad_norm within 1e-3 relative; the assignments dropped a step (over
# the forward and the recompute, summed over the ranks) equal at step 1,
# from the same weights. From step 2 the ranks' params differ from one
# process's by bf16 rounding (each row's gradient from its own backward,
# the two summed in float32), and a routing that sits on a bf16 tie can
# flip: the later steps' drops within DIST_H_DROPS of the assignments
# routed (in float32 compute they stay equal at every step)
DIST_H_DROPS = 1e-3
# (i) a Pod with a batch axis: the two ranks on a (data 2, model 1) mesh
# serve (f)'s llama3.2-3b Pod (float32, full width and depth, paged, page
# 16, 8 slots: 4 a rank, prefix cache) on (f)'s 8 requests: every rank's
# tokens and admit ticks equal (f)'s one float32 process's, K1 = 28 x
# decode steps at K1_DP and K2 = 28 x prefills a rank, the token gather's
# bytes a decode step = 8 slots x chunk x 4
POD_DP = ("llama3.2-3b",)


def _pod_tp_image(arch: str) -> str:
    layers = POD_TP[arch][0]
    return POD_TP_IMAGEFILE.format(
        arch=arch, layers=f" n_layers={layers}" if layers else "")


def _pod_tp_requests(GenRequest, arch: str) -> list:
    """(f)'s requests for ``arch``: for llama3.2-3b the serve phase's
    first four and the first four that share its prefix; else one prompt
    of each length (seed 15)."""
    import numpy as np
    from repro_torch.configs import get_config
    vocab = get_config(arch).vocab_size
    lengths = POD_TP[arch][3]
    if lengths is None:
        reqs = _llama_reqs(GenRequest, vocab)
        return [GenRequest(rid=i, prompt=r.prompt, max_new_tokens=POD_TP_NEW,
                           prefix_len=r.prefix_len)
                for i, r in enumerate(reqs[:4] + reqs[8:12])]
    rng = np.random.default_rng(15)
    return [GenRequest(rid=i, prompt=rng.integers(0, vocab, n),
                       max_new_tokens=POD_TP_NEW)
            for i, n in enumerate(lengths)]


def _pod_tp_shapes() -> dict:
    """The per-rank kernel shapes (f)'s prefills and decodes call, from
    the requests and the engine's rules: a prefill of a prompt in its
    bucket (a recurrent arch's at its exact length), a prompt that finds
    the registered 256-token prefix (every shared one after the first:
    the scheduler admits the requests in order) as its suffix's bucket
    over the prefix, at a model-axis rank's heads and at all of them (the
    (i) Pod's prefills, whole on each data replica); K1 at llama's 8
    slots over a table of 1024 / 16 pages (K1_TP) and at a data
    replica's 4 of them (K1_DP). Keys as ``_shape_gate`` reads them: k1 (B,
    n_kv, g, hd, ps, mp, dtype), k2 (B, Hq, Hkv, d, Sq, Sk, window, dtype),
    k4 (B, S, R), k5 (b, S, H, P, N, chunk)."""
    from repro_torch.orchestrator import GenRequest
    from repro_torch.orchestrator.scheduler import _PREFILL_BUCKETS
    bucket = lambda n: next(b for b in _PREFILL_BUCKETS if b >= n)  # noqa
    out = {"k1": set(K1_TP + K1_DP), "k2": set(), "k4": set(),
           "k5": set()}
    registered = False
    for r in _pod_tp_requests(GenRequest, "llama3.2-3b"):
        n, L = len(r.prompt), r.prefix_len
        # a rank of (f)'s model axis: 12 / 4 heads; of (i)'s data axis:
        # the prefill whole, 24 / 8
        for hq, hkv in ((12, 4), (24, 8)):
            if L and registered:
                b = min(bucket(n - L), 1024 - L)
                out["k2"].add((1, hq, hkv, 128, b, L + b, 0, "float32"))
            else:
                out["k2"].add((1, hq, hkv, 128, bucket(n), bucket(n), 0,
                               "float32"))
        registered |= bool(L)
    for n in POD_TP["recurrentgemma-2b"][3]:
        out["k2"].add((1, 5, 1, 256, n, n, 2048, "float32"))
        out["k4"].add((1, n, 1280))
    for n in POD_TP["mamba2-2.7b"][3]:
        out["k5"].add((1, n, 40, 64, 128, min(256, n)))
    return {k: sorted(v) for k, v in out.items()}


def _dist_launches(arch: str, layers: int) -> dict:
    """The kernel launches one rank of (d) or (e) makes in DIST_D_STEPS
    steps under remat (a forward and the backward's recompute a step, then
    one backward): K2 per attention layer, K4 per rec layer, K5 per ssm
    layer, twice a step each; K2's and K5's backward and K4's reverse scan
    once."""
    from repro_torch.configs import get_config
    kinds = get_config(arch, n_layers=layers).layer_types()
    rec = kinds.count("rec")
    attn = sum(k in ("attn", "moe") for k in kinds)
    per = {"flash_attention_fwd": 2 * attn, "flash_attention_bwd": attn,
           "rglru_scan": 2 * rec, "ssd": 2 * kinds.count("ssm"),
           "rglru_scan_bwd": rec, "ssd_bwd": kinds.count("ssm")}
    return {k: n * DIST_D_STEPS for k, n in per.items() if n}


def _ranks_runs(torch, workdir: Path, runs: list, pods=(),
                dp_pods=()) -> tuple:
    """Run the (d), (e), (g) and (h) runs, (f)'s pods and (i)'s in one
    ``torchrun --nproc-per-node 2 chip_smoke.py --tp-worker`` job: (every
    rank's records by run name -- a pod's is ``pod {arch}`` on (f)'s
    (1, 2) mesh, ``pod21 {arch}`` on (i)'s (2, 1) --, which ranks held the
    card's device node, card memory polled, seconds, failure text or
    None)."""
    root = workdir / "dist_de"
    root.mkdir()
    out, spec = root / "ranks.json", root / "spec.json"
    pod_list = ([[a, [1, 2]] for a in pods]
                + [[a, [2, 1]] for a in dp_pods])
    spec.write_text(json.dumps({"runs": runs, "pods": pod_list,
                                "steps": DIST_D_STEPS,
                                "root": str(root / "rt"), "out": str(out)}))
    seen: dict[int, bool] = {}
    used = [_device_used_mib()]

    def watch(pids):
        for pid in pids:
            if not seen.get(pid):
                try:
                    seen[pid] = _opens_card(pid)
                except OSError:
                    continue
        used.append(_device_used_mib())

    torch.cuda.empty_cache()
    rc, tail, wall = _torchrun_cmd(
        2, [str(ROOT / "chip_smoke.py"), "--tp-worker", str(spec)], root,
        watch=watch)
    if rc != 0 or not out.exists():
        return {}, seen, used, wall, f"exit {rc}: {tail}"
    ranks = json.loads(out.read_text())
    names = ([run["name"] for run in runs] + [f"pod {a}" for a in pods]
             + [f"pod21 {a}" for a in dp_pods])
    by_run = {name: [r[j] for r in ranks] for j, name in enumerate(names)}
    return by_run, seen, used, wall, None


def _shape_gate(rs: list, state) -> tuple[dict, bool]:
    """Every K1, K2, K2 backward, K4 and K5 shape the ranks called, and
    whether each is one the kernels phase held to its plain version."""
    pod = _pod_tp_shapes()
    checked = {"k1": set(state.get("k1_checked", ())),
               "k2": {(*c, True) for c in state.get("k2_checked", ())},
               "k2_bwd": set(state.get("k2_bwd_checked", ())),
               "k4": set(K4_TP) | set(pod["k4"]),
               "k5": set(K5_TP) | set(pod["k5"])}
    shapes = {k: sorted({tuple(x) for r in rs for x in r["shapes"][k]})
              for k in checked}
    return shapes, all(set(v) <= checked[k] for k, v in shapes.items())


def _dist_d_image(arch: str) -> str:
    return DIST_IMAGEFILE.format(arch=arch,
                                 layers=f" n_layers={DIST_D[arch]}",
                                 collectives="generic")


def _dist_de(torch, state, workdir: Path, llama_ref: tuple) -> list[str]:
    """(d) tensor parallelism, (e) FSDP, (f) serving on the model axis,
    (g) PowerSGD on it, (h) the MoE over data replicas and (i) a Pod with
    a batch axis on two ranks sharing the card, in one torchrun job: each
    (d) run against one process on the same global batch (``llama_ref``:
    llama3.2-3b's, computed by the phase), each (e) arm against (b)'s
    two-microbatch process, (f)'s and (i)'s llama3.2-3b pods against one
    float32 process's pod on the same requests, run here first and
    released, (g) against one process's PowerSGD steps, (h) against (d)'s
    moonshot-v1-16b-a3b process."""
    import shutil
    from repro_torch.configs import get_config
    failures, runs, refs = [], [], {"llama3.2-3b": llama_ref}
    texts, moe_drops = {}, []
    pod_ref = _pod_tp_serve(torch, "llama3.2-3b", workdir / "pod_ref")
    for name, n in pod_ref["launches"].items():
        state["launches"][name] = state["launches"].get(name, 0) + n
    for arch, layers in DIST_D.items():
        text = _dist_d_image(arch)
        if arch not in refs:
            refs[arch] = _dist_reference(
                torch, workdir, text, DIST_D_STEPS,
                drops=moe_drops if arch == "moonshot-v1-16b-a3b" else None)
        runs.append({"name": arch, "mesh": [1, 2], "imagefile": text})
    for name, (coll, remat) in DIST_E.items():
        text = DIST_IMAGEFILE.format(arch="llama3.2-3b",
                                     layers=f" n_layers={DIST_B_LAYERS}",
                                     collectives=coll)
        texts[f"fsdp {name}"] = text + f"SET fsdp=true remat={remat}\n"
        runs.append({"name": f"fsdp {name}", "mesh": [2, 1],
                     "imagefile": texts[f"fsdp {name}"]})
    g_text = _dist_g_image()
    # one process at model 1: the same initial Q (the whole leaves' draws,
    # from the same generator)
    refs["psgd"] = _dist_reference(torch, workdir, g_text, DIST_D_STEPS)
    runs.append({"name": "psgd", "mesh": [1, 2], "imagefile": g_text})
    runs.append({"name": "moe_dp", "mesh": [2, 1],
                 "imagefile": _dist_d_image("moonshot-v1-16b-a3b")})
    by_run, seen, used, wall, err = _ranks_runs(torch, workdir, runs,
                                                POD_TP, POD_DP)
    shutil.rmtree(workdir / "dist_de")
    if err:
        return [f"(d)-(i): {err}"]
    for rs in by_run.values():
        for r in rs:
            for name, n in r["launches"].items():
                state["launches"][name] = state["launches"].get(name, 0) + n
    mem = (f"card memory in use {used[0]} MiB before, {max(used)} MiB at "
           f"most during the ranks' run of {wall:.1f} s")
    for arch, layers in DIST_D.items():
        rs = by_run[arch]
        ref, ref_peak = refs[arch]
        cfg = get_config(arch, n_layers=layers)
        r0 = rs[0]["steps"]
        same = all(r["steps"][i]["loss"] == r0[i]["loss"]
                   for r in rs for i in range(DIST_D_STEPS))
        dl = max(abs(s["loss"] - l) / abs(l) for s, (l, _) in zip(r0, ref))
        dg = max(abs(s["grad_norm"] - g) / g for s, (_, g) in zip(r0, ref))
        want_tp = tp_wire_bytes(cfg, cfg.n_kv_heads, DIST_D_TOKENS, 2,
                                "full")
        tp = [s["tp"] for r in rs for s in r["steps"]]
        want = _dist_launches(arch, layers)
        counts = [{k: n for k, n in r["launches"].items() if n} for r in rs]
        shapes, shapes_ok = _shape_gate(rs, state)
        on_card = [seen.get(r["pid"], False) for r in rs]
        ok = (same and dl <= DIST_D_TOL and dg <= DIST_D_TOL
              and tp == [want_tp] * len(tp) and counts == [want] * 2
              and shapes_ok and all(on_card))
        med = [statistics.median(s["seconds"] for s in r["steps"][1:])
               for r in rs]
        log(f"dist: (d) torchrun --nproc-per-node 2, mesh (data 1, model "
            f"2), {arch} {layers} layers, generic: losses "
            f"{[round(s['loss'], 6) for s in r0]} vs one process "
            f"{[round(l, 6) for l, _ in ref]}: max loss rel diff {dl:.2e}, "
            f"max grad_norm rel diff {dg:.2e} (tol {DIST_D_TOL:g}); every "
            f"rank's loss equal {same}; TP bytes a step a rank {tp} "
            f"(formula {want_tp}); launches a rank {counts} (expected "
            f"{want}); K2 shapes (B, Hq, Hkv, d, Sq, Sk, window, dtype, "
            f"causal) {shapes['k2']}, its backward {shapes['k2_bwd']}, K4 "
            f"(B, S, R) {shapes['k4']}, K5 (b, S, H, P, N, chunk) "
            f"{shapes['k5']}, all checked by the kernels phase "
            f"{shapes_ok}; ranks hold /dev/nvidia* open "
            f"{on_card}; step s after the first (median) {med}, model-axis "
            f"collective s {[round(r['collective_seconds'], 3) for r in rs]}"
            f"; peak memory a rank {[round(_gib(r['peak']), 2) for r in rs]}"
            f" GiB vs one process {_gib(ref_peak):.2f} GiB; {mem} "
            f"{'ok' if ok else 'FAIL'} [{state['card']}]")
        state["dist"][f"d {arch}"] = dict(
            step_s=[[s["seconds"] for s in r["steps"]] for r in rs],
            peak_gib=[_gib(r["peak"]) for r in rs],
            ref_peak_gib=_gib(ref_peak), tp_bytes=want_tp, wall_s=wall)
        state["dist_ranks"][f"d {arch}"] = dict(
            text=_dist_d_image(arch), mesh=(1, 2), steps=DIST_D_STEPS,
            by_op=rs[0]["by_op"], launches=rs[0]["launches"])
        if not ok:
            failures.append(
                f"(d) {arch}: dloss {dl:.2e}, dgnorm {dg:.2e}, equal "
                f"{same}, tp {tp} vs {want_tp}, launches {counts} vs "
                f"{want}, shapes {shapes} checked {shapes_ok}, on card "
                f"{on_card}")
    cfg = get_config("llama3.2-3b", n_layers=DIST_B_LAYERS)
    ref = state.get("dist_b_ref", [])
    for name, (coll, remat) in DIST_E.items():
        rs = by_run[f"fsdp {name}"]
        r0 = rs[0]["steps"]
        b_peak = state.get("dist_b_peak", {}).get(name, 0)
        same = all(r["steps"][i]["loss"] == r0[i]["loss"]
                   for r in rs for i in range(DIST_D_STEPS))
        dl = max((abs(s["loss"] - l) for s, (l, _) in zip(r0, ref)),
                 default=float("inf"))
        dg = max((abs(s["grad_norm"] - g) / g
                  for s, (_, g) in zip(r0, ref)), default=float("inf"))
        bit = [s["loss"] == l for s, (l, _) in zip(r0, ref)]
        want_wire = fsdp_wire_bytes(cfg, 2, 1, remat, 4)
        wire = [s["wire"] for r in rs for s in r["steps"]]
        want = _dist_launches("llama3.2-3b", DIST_B_LAYERS)
        counts = [{k: n for k, n in r["launches"].items() if n} for r in rs]
        shapes, shapes_ok = _shape_gate(rs, state)
        on_card = [seen.get(r["pid"], False) for r in rs]
        peaks = [r["peak"] for r in rs]
        ok = (same and len(ref) == DIST_D_STEPS and dl <= DIST_B[name][1]
              and dg <= DIST_B[name][1] and wire == [want_wire] * len(wire)
              and 0 < max(peaks) < b_peak and counts == [want] * 2
              and shapes_ok and all(on_card))
        med = [statistics.median(s["seconds"] for s in r["steps"][1:])
               for r in rs]
        log(f"dist: (e) torchrun --nproc-per-node 2, mesh (data 2, model "
            f"1), llama3.2-3b {DIST_B_LAYERS} layers, {coll} + fsdp=true, "
            f"remat={remat}: losses {[round(s['loss'], 6) for s in r0]} vs "
            f"(b)'s one process in two microbatches "
            f"{[round(l, 6) for l, _ in ref]}: max |dloss| {dl:.2e}, max "
            f"grad_norm rel diff {dg:.2e} (tol {DIST_B[name][1]:g}), "
            f"bit-equal {bit}; every rank's loss equal {same}; ABI bytes a "
            f"step a rank {wire} (fsdp_wire_bytes {want_wire}; by "
            f"operation over the run {rs[0]['by_op'].get(coll)}); launches "
            f"a rank {counts} (expected {want}); K2 shapes {shapes['k2']} "
            f"(backward {shapes['k2_bwd']}) checked {shapes_ok}; ranks hold "
            f"/dev/nvidia* open {on_card}; "
            f"step s after the first (median) {med}, collective s "
            f"{[round(r['collective_seconds'], 3) for r in rs]}; peak "
            f"memory a rank {[round(_gib(p), 2) for p in peaks]} GiB vs "
            f"(b) {name}'s {_gib(b_peak):.2f} GiB; {mem} "
            f"{'ok' if ok else 'FAIL'} [{state['card']}]")
        state["dist"][f"e {name}"] = dict(
            step_s=[[s["seconds"] for s in r["steps"]] for r in rs],
            peak_gib=[_gib(p) for p in peaks], b_peak_gib=_gib(b_peak),
            wire=want_wire, wall_s=wall)
        state["dist_ranks"][f"e {name}"] = dict(
            text=texts[f"fsdp {name}"], mesh=(2, 1), steps=DIST_D_STEPS,
            by_op=rs[0]["by_op"], launches=rs[0]["launches"])
        if not ok:
            failures.append(
                f"(e) {name}: dloss {dl:.2e}, dgnorm {dg:.2e}, equal "
                f"{same}, wire {wire} vs {want_wire}, peak {peaks} vs "
                f"{b_peak}, launches {counts} vs {want}, shapes {shapes} "
                f"checked {shapes_ok}, on card {on_card}")
    for arch in POD_TP:
        failures += _pod_tp_gate(state, arch, by_run[f"pod {arch}"],
                                 pod_ref if arch == "llama3.2-3b" else None,
                                 seen, mem)
    failures += _dist_g(state, by_run["psgd"], refs["psgd"], seen, mem)
    failures += _dist_h(state, by_run["moe_dp"], refs["moonshot-v1-16b-a3b"],
                        moe_drops, seen, mem)
    for arch in POD_DP:
        failures += _pod_tp_gate(state, arch, by_run[f"pod21 {arch}"],
                                 pod_ref, seen, mem, mesh=(2, 1))
    return failures


def _dist_g(state, rs: list, ref: tuple, seen: dict,
            mem: str) -> list[str]:
    """(g)'s gates and printout: PowerSGD on the (data 1, model 2) mesh
    against one process at model 1."""
    from repro_torch.configs import get_config
    ref, ref_peak = ref
    cfg = get_config("llama3.2-3b", n_layers=DIST_G_LAYERS)
    r0 = rs[0]["steps"]
    same = all(r["steps"][i]["loss"] == r0[i]["loss"]
               for r in rs for i in range(DIST_D_STEPS))
    dl = max(abs(s["loss"] - l) / abs(l) for s, (l, _) in zip(r0, ref))
    dg = max(abs(s["grad_norm"] - g) / g for s, (_, g) in zip(r0, ref))
    want = powersgd_wire_bytes(cfg, 1, 2, DIST_G_RANK)
    splits = powersgd_splits(cfg, 2, DIST_G_RANK)
    # compressed leaves by the branch they take: rows, columns, and of
    # the columns those whose Q rows are strided (a stacked leaf split on
    # its last dim)
    kinds = {"rows": sum(d == 0 for d in splits.values()),
             "columns": sum(bool(d) for d in splits.values()),
             "strided": sum(bool(d) and d >= 2 for d in splits.values())}
    wire = [s["wire"] for r in rs for s in r["steps"]]
    # float32 compute: 4-byte activations on the model axis
    want_tp = tp_wire_bytes(cfg, cfg.n_kv_heads, DIST_D_TOKENS, 4, "full")
    tp = [s["tp"] for r in rs for s in r["steps"]]
    launches = _dist_launches("llama3.2-3b", DIST_G_LAYERS)
    counts = [{k: n for k, n in r["launches"].items() if n} for r in rs]
    shapes, shapes_ok = _shape_gate(rs, state)
    on_card = [seen.get(r["pid"], False) for r in rs]
    ok = (same and dl <= DIST_D_TOL and dg <= DIST_D_TOL
          and min(kinds.values()) > 0
          and wire == [want["model"]] * len(wire)
          and tp == [want_tp] * len(tp) and counts == [launches] * 2
          and shapes_ok and all(on_card))
    med = [statistics.median(s["seconds"] for s in r["steps"][1:])
           for r in rs]
    log(f"dist: (g) PowerSGD (rank {DIST_G_RANK}, float32 means) on the "
        f"(data 1, model 2) mesh, llama3.2-3b {DIST_G_LAYERS} layers in "
        f"float32 compute, host mode=explicit: compressed leaves by split "
        f"{kinds} of "
        f"{len(splits)}; losses {[round(s['loss'], 6) for s in r0]} "
        f"vs one process at model 1 {[round(l, 6) for l, _ in ref]}: max "
        f"loss rel diff {dl:.2e}, max grad_norm rel diff {dg:.2e} (tol "
        f"{DIST_D_TOL:g}); every rank's loss equal {same}; the model "
        f"axis's PowerSGD bytes a step a rank {wire} (powersgd_wire_bytes "
        f"{want['model']}); TP bytes a step {tp} (formula {want_tp}); "
        f"launches a rank {counts} (expected {launches}); K2 shapes "
        f"{shapes['k2']} (backward {shapes['k2_bwd']}) checked {shapes_ok}; "
        f"ranks hold /dev/nvidia* open "
        f"{on_card}; step s after the first (median) {med}; peak memory a "
        f"rank {[round(_gib(r['peak']), 2) for r in rs]} GiB vs one "
        f"process {_gib(ref_peak):.2f} GiB; {mem} {'ok' if ok else 'FAIL'} "
        f"[{state['card']}]")
    state["dist"]["g psgd"] = dict(
        step_s=[[s["seconds"] for s in r["steps"]] for r in rs],
        peak_gib=[_gib(r["peak"]) for r in rs], ref_peak_gib=_gib(ref_peak),
        psgd_model_bytes=want["model"], dloss=dl, dgnorm=dg)
    if ok:
        return []
    return [f"(g): dloss {dl:.2e}, dgnorm {dg:.2e}, equal {same}, "
            f"compressed by split {kinds}, wire "
            f"{wire} vs {want['model']}, tp {tp} vs {want_tp}, launches "
            f"{counts} vs {launches}, shapes {shapes} checked {shapes_ok}, "
            f"on card {on_card}"]


def _dist_h(state, rs: list, ref: tuple, ref_drops: list, seen: dict,
            mem: str) -> list[str]:
    """(h)'s gates and printout: moonshot-v1-16b-a3b on the (data 2,
    model 1) mesh, the MoE dispatched over the global batch, against one
    process on both rows in one microbatch."""
    ref, ref_peak = ref
    arch = "moonshot-v1-16b-a3b"
    r0 = rs[0]["steps"]
    same = all(r["steps"][i]["loss"] == r0[i]["loss"]
               for r in rs for i in range(DIST_D_STEPS))
    dl = max(abs(s["loss"] - l) / abs(l) for s, (l, _) in zip(r0, ref))
    dg = max(abs(s["grad_norm"] - g) / g for s, (_, g) in zip(r0, ref))
    drops = [sum(r["steps"][i]["drops"] for r in rs)
             for i in range(DIST_D_STEPS)]
    # the assignments routed a step: both rows' tokens x top-k, a MoE
    # layer, in the forward and the recompute
    from repro_torch.configs import get_config
    cfg = get_config(arch, n_layers=DIST_D[arch])
    routed = (DIST_D_TOKENS * cfg.top_k * 2
              * sum(k == "moe" for k in cfg.layer_types()))
    drops_ok = (drops[:1] == ref_drops[:1] and len(drops) == len(ref_drops)
                and all(abs(a - b) <= DIST_H_DROPS * routed
                        for a, b in zip(drops, ref_drops)))
    launches = _dist_launches(arch, DIST_D[arch])
    counts = [{k: n for k, n in r["launches"].items() if n} for r in rs]
    shapes, shapes_ok = _shape_gate(rs, state)
    on_card = [seen.get(r["pid"], False) for r in rs]
    # the generic all-reduce of every gradient, and the count gathers of
    # the MoE layer in the forward and the remat's recompute
    want_wire = generic_wire_bytes(cfg)
    wire = [s["wire"] for r in rs for s in r["steps"]]
    want_moe = moe_count_bytes(cfg, 2, recompute=True)
    moe = [s["moe"] for r in rs for s in r["steps"]]
    ok = (same and dl <= DIST_D_TOL and dg <= DIST_D_TOL
          and drops_ok and wire == [want_wire] * len(wire)
          and moe == [want_moe] * len(moe) and counts == [launches] * 2
          and shapes_ok and all(on_card))
    med = [statistics.median(s["seconds"] for s in r["steps"][1:])
           for r in rs]
    log(f"dist: (h) the MoE over data replicas on the (data 2, model 1) "
        f"mesh, {arch} {DIST_D[arch]} layers (64 experts whole a rank), "
        f"generic, one 2048-token row a rank: losses "
        f"{[round(s['loss'], 6) for s in r0]} vs one process on both rows "
        f"in one microbatch {[round(l, 6) for l, _ in ref]}: max loss rel "
        f"diff {dl:.2e}, max grad_norm rel diff {dg:.2e} (tol "
        f"{DIST_D_TOL:g}); every rank's loss equal {same}; assignments "
        f"dropped a step (forward and recompute, both ranks) {drops} vs one "
        f"process {ref_drops} of {routed} routed (step 1 equal, later "
        f"steps within {DIST_H_DROPS:g} of it) {drops_ok}; ABI bytes a "
        f"step a rank {wire} (generic_wire_bytes {want_wire}); the count "
        f"gathers' bytes a step a rank {moe} (moe_count_bytes "
        f"{want_moe}); launches a rank {counts} (expected {launches}); K2 "
        f"shapes {shapes['k2']} (backward {shapes['k2_bwd']}) checked "
        f"{shapes_ok}; ranks hold "
        f"/dev/nvidia* open {on_card}; step s after the first (median) "
        f"{med}, collective s "
        f"{[round(r['collective_seconds'], 3) for r in rs]}; peak memory a "
        f"rank {[round(_gib(r['peak']), 2) for r in rs]} GiB vs one "
        f"process {_gib(ref_peak):.2f} GiB; {mem} {'ok' if ok else 'FAIL'} "
        f"[{state['card']}]")
    state["dist"]["h moe"] = dict(
        step_s=[[s["seconds"] for s in r["steps"]] for r in rs],
        peak_gib=[_gib(r["peak"]) for r in rs], ref_peak_gib=_gib(ref_peak),
        drops=drops, dloss=dl, dgnorm=dg)
    if ok:
        return []
    return [f"(h): dloss {dl:.2e}, dgnorm {dg:.2e}, equal {same}, drops "
            f"{drops} vs {ref_drops}, wire {wire} vs {want_wire}, moe "
            f"{moe} vs {want_moe}, launches {counts} vs {launches}, "
            f"shapes {shapes} checked {shapes_ok}, on card {on_card}"]


def _pod_tp_gate(state, arch: str, rs: list, ref: dict | None, seen: dict,
                 mem: str, mesh: tuple = (1, 2)) -> list[str]:
    """(f)'s gates on one pod's rank records (and (i)'s, ``mesh`` (2,
    1)): every request done with POD_TP_NEW tokens, tokens and admit
    ticks equal on every rank (and, given ``ref``, to one process's),
    launches a rank exactly the layers of each kernel's path times its
    prefill dispatches or decode steps and nothing else, every
    K1/K2/K4/K5 shape one the kernels phase held to its plain version,
    every rank on the card; on a batch axis each rank's rows its half of
    the slot bank, K1 at K1_DP and the token gather's bytes = decode
    dispatches x slots x chunk x 4 int32; and its printout."""
    layers, pod_kw, expect, _ = POD_TP[arch]
    part = "f" if mesh == (1, 2) else "i"
    r0 = rs[0]
    same = all(r["tokens"] == r0["tokens"] and r["admit"] == r0["admit"]
               for r in rs)
    done = all(r0["done"]) and all(len(t) == POD_TP_NEW
                                   for t in r0["tokens"])
    to_ref = ref is None or (ref["tokens"] == r0["tokens"]
                             and ref["admit"] == r0["admit"])
    want = [{k: n * (r["prefills"] if per == "prefill" else
                     r["decode_steps"]) for k, (per, n) in expect.items()}
            for r in rs]
    counts = [{k: n for k, n in r["launches"].items() if n} for r in rs]
    shapes, shapes_ok = _shape_gate(rs, state)
    on_card = [seen.get(r["pid"], False) for r in rs]
    slots = pod_kw["n_slots"]
    gather = [r["gather_bytes"] for r in rs]
    want_gather = [r["decode_dispatches"] * slots * r["chunk"] * 4
                   * (mesh[0] > 1) for r in rs]
    rows = [r["rows"] for r in rs]
    half = slots // mesh[0]
    want_rows = [[(i // mesh[1]) * half, (i // mesh[1] + 1) * half]
                 for i in range(len(rs))]
    ok = (same and done and to_ref and counts == want and shapes_ok
          and all(on_card) and gather == want_gather and rows == want_rows
          and (part == "f" or shapes["k1"] == sorted(K1_DP)))
    tok_s = [r["decode_tokens"] / r["decode_s"] for r in rs]
    steps = r0["decode_steps"]
    tp_b = [r["tp_decode"]["bytes"] for r in rs]
    tp_s = [r["tp_decode"]["seconds"] for r in rs]
    ref_txt = ("" if ref is None else
               f"; tokens and admit ticks equal one float32 process's pod "
               f"{to_ref} (its decode {ref['decode_tokens']} tokens in "
               f"{ref['decode_s']:.3f} s = "
               f"{ref['decode_tokens'] / ref['decode_s']:.1f} tokens/s, "
               f"peak memory {_gib(ref['peak']):.2f} GiB)")
    log(f"dist: ({part}) Pod on the (data {mesh[0]}, model {mesh[1]}) "
        f"mesh, {arch}"
        f"{f' cut to {layers} layers' if layers else ' full depth'}, "
        f"float32, {len(r0['tokens'])} requests: all done with "
        f"{POD_TP_NEW} tokens {done}; every rank's tokens and admit ticks "
        f"equal {same}{ref_txt}; prefill dispatches {r0['prefills']}, "
        f"decode steps {steps}, prefix hits {r0['prefix_hits']}; launches "
        f"a rank {counts} (expected {want}); shapes K1 (B, n_kv, g, hd, ps,"
        f" mp, dtype) {shapes['k1']}, K2 {shapes['k2']}, K4 "
        f"{shapes['k4']}, K5 {shapes['k5']}, all checked by the kernels "
        f"phase {shapes_ok}; ranks hold /dev/nvidia* open {on_card}; "
        f"decode tokens/s a rank {[round(t, 1) for t in tok_s]}; model-axis"
        f" collectives over the decode {tp_b} bytes in "
        f"{[round(t, 3) for t in tp_s]} s a rank = "
        f"{[b // max(steps, 1) for b in tp_b]} bytes and "
        f"{[round(1e3 * t / max(steps, 1), 3) for t in tp_s]} ms a decode "
        f"step ({[round(b / max(r['decode_tokens'], 1)) for b, r in zip(tp_b, rs)]}"
        f" bytes a decode token); prefill s a rank "
        f"{[round(r['prefill_s'], 3) for r in rs]}, decode s "
        f"{[round(r['decode_s'], 3) for r in rs]}, wall s "
        f"{[round(r['wall_s'], 2) for r in rs]}; slot rows a rank {rows}; "
        f"the token gather over the run {gather} bytes a rank (formula "
        f"{want_gather}) = "
        f"{[g // max(r['decode_dispatches'], 1) for g, r in zip(gather, rs)]}"
        f" bytes a decode dispatch; peak memory a rank "
        f"{[round(_gib(r['peak']), 2) for r in rs]} GiB; {mem} "
        f"{'ok' if ok else 'FAIL'} [{state['card']}]")
    state["dist"][f"{part} {arch}"] = dict(
        decode_tok_s=tok_s, tp_decode=[r["tp_decode"] for r in rs],
        decode_steps=steps, peak_gib=[_gib(r["peak"]) for r in rs],
        ref_peak_gib=None if ref is None else _gib(ref["peak"]),
        wall_s=[r["wall_s"] for r in rs], gather_bytes=gather)
    if ok:
        return []
    return [f"({part}) {arch}: done {done}, ranks equal {same}, equal one "
            f"process {to_ref}, launches {counts} vs {want}, shapes "
            f"{shapes} checked {shapes_ok}, on card {on_card}, gather "
            f"{gather} vs {want_gather}, rows {rows} vs {want_rows}"]


def tp_worker(spec_path: str) -> int:
    """One rank of the dist phase's (d)-(i), started by torchrun:
    joins a gloo group and, for each run of the spec, makes the run's
    (data, model) mesh (each shape once), builds the port's Container on
    it and its train step (``Container.train_step_fn``), takes the steps,
    and records its losses, grad norms, the bytes each step handed to the
    model axis and to the ABI, step seconds, peak memory, kernel launches
    and the shapes of its K1, K2, K2 backward, K4 and K5 calls, and an
    MoE run's
    dropped assignments a step; then, for each pod of the spec, serves
    the pod's requests through a ``Pod`` on its mesh ((data 1, model 2)
    or (data 2, model 1)) and a ``ContinuousScheduler``
    (``_pod_tp_serve``); rank 0 writes every rank's records."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.core.runtime import Runtime
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["RANK"])
    device = torch.device(
        f"cuda:{int(os.environ['LOCAL_RANK']) % torch.cuda.device_count()}")
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method="env://", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    shapes = {"k1": set(), "k2": set(), "k2_bwd": set(), "k4": set(),
              "k5": set()}
    real = (fa_ops.flash_attention_fwd_cuda, rg_ops.rglru_scan_cuda,
            ssd_ops.ssd_cuda, pa_ops.paged_attention_cuda,
            fa_ops.flash_attention_bwd_cuda)

    def k1(q, kp, vp, table, lengths, **kw):
        shapes["k1"].add((q.shape[0], kp.shape[0], q.shape[1] // kp.shape[0],
                          q.shape[2], kp.shape[2], table.shape[1],
                          str(q.dtype).removeprefix("torch.")))
        return real[3](q, kp, vp, table, lengths, **kw)

    def k2(q, k, v, *, causal=True, window=0, **kw):
        shapes["k2"].add((q.shape[0], q.shape[1], k.shape[1], q.shape[3],
                          q.shape[2], k.shape[2], int(window),
                          str(q.dtype).removeprefix("torch."), bool(causal)))
        return real[0](q, k, v, causal=causal, window=window, **kw)

    def k2_bwd(q, k, v, out, lse, dout, *, causal=True, window=0, **kw):
        shapes["k2_bwd"].add(_k2_key(q, k, window, causal))
        return real[4](q, k, v, out, lse, dout, causal=causal, window=window,
                       **kw)

    def k4(a, b, reverse=False):
        shapes["k4"].add(tuple(a.shape))
        return real[1](a, b, reverse)

    def k5(x, dt, A, B, C, chunk):
        shapes["k5"].add((*x.shape, B.shape[-1], chunk))
        return real[2](x, dt, A, B, C, chunk)
    fa_ops.flash_attention_fwd_cuda = k2
    fa_ops.flash_attention_bwd_cuda = k2_bwd
    rg_ops.rglru_scan_cuda = k4
    ssd_ops.ssd_cuda = k5
    pa_ops.paged_attention_cuda = k1
    try:
        meshes, records = {}, []
        for run in spec["runs"]:
            shape = tuple(run["mesh"])
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, ("data", "model"))
            mesh = meshes[shape]
            rt = Runtime(Path(spec["root"]) / f"rank{rank}")
            c = rt.run(rt.build(run["imagefile"]), mesh=mesh)
            params = c.init_params(0)
            opt = c.init_opt_state(params)
            step = c.train_step_fn(donate=True)
            data = SyntheticLM(DataConfig(
                vocab_size=c.arch.vocab_size, seq_len=c.cell.seq_len,
                global_batch=c.cell.global_batch, seed=0))
            for seen in shapes.values():
                seen.clear()
            _reset_counts()
            mesh.stats.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps = []
            for i in range(spec["steps"]):
                tp0, t0 = mesh.stats.wire_bytes("tp"), time.perf_counter()
                w0 = mesh.stats.wire_bytes(c.abi.name)
                moe0 = mesh.stats.wire_bytes("moe")
                calls: list = []
                with (_moe_drop_counter(calls) if c.arch.n_experts
                      else nullcontext()):
                    params, opt, m = step(params, opt, data.batch(i))
                loss = float(m["loss"])        # waits for the step
                steps.append({"loss": loss,
                              "grad_norm": float(m["grad_norm"]),
                              "tp": mesh.stats.wire_bytes("tp") - tp0,
                              "wire": mesh.stats.wire_bytes(c.abi.name) - w0,
                              "moe": mesh.stats.wire_bytes("moe") - moe0,
                              "drops": sum(int((~k).sum()) for k in calls),
                              "seconds": time.perf_counter() - t0})
            records.append({
                "name": run["name"], "rank": rank, "pid": os.getpid(),
                "device": str(device), "steps": steps,
                "peak": torch.cuda.max_memory_allocated(),
                "launches": _launch_counts(),
                "shapes": {k: sorted(v) for k, v in shapes.items()},
                "by_op": json.loads(json.dumps(mesh.stats.bytes)),
                "collective_seconds": mesh.stats.seconds})
            del params, opt, m, step, c
            torch.cuda.empty_cache()
        for arch, shape in spec.get("pods", ()):
            shape = tuple(shape)
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, ("data", "model"))
            mesh = meshes[shape]
            mesh.stats.reset()
            for seen in shapes.values():
                seen.clear()
            name = "pod" if shape == (1, 2) else "pod21"
            records.append({"name": f"{name} {arch}", "rank": rank,
                            "pid": os.getpid(), **_pod_tp_serve(
                                torch, arch, Path(spec["root"])
                                / f"pod{rank}", mesh),
                            "shapes": {k: sorted(v)
                                       for k, v in shapes.items()}})
        everything = mesh.gather_objects(records)
        if rank == 0:
            Path(spec["out"]).write_text(json.dumps(everything))
    finally:
        (fa_ops.flash_attention_fwd_cuda, rg_ops.rglru_scan_cuda,
         ssd_ops.ssd_cuda, pa_ops.paged_attention_cuda,
         fa_ops.flash_attention_bwd_cuda) = real
        dist.destroy_process_group()
    return 0


def _pod_tp_serve(torch, arch: str, root: Path, mesh=None) -> dict:
    """Serve (f)'s requests for ``arch`` through a port Pod (params from
    seed 0; on ``mesh`` when given, else one process) and a
    ContinuousScheduler, the kernel counters set to 0 just before the
    scheduler runs and read just after: tokens and admit ticks a request,
    launches, prefill dispatches, decode steps and tokens, prefill and
    decode seconds, the model axis's bytes and seconds over the decode
    dispatches, the run's wall seconds and peak memory."""
    import shutil

    from repro_torch.core.runtime import Runtime
    from repro_torch.orchestrator import ContinuousScheduler, GenRequest, Pod
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt = Runtime(root)
    rt.build(_pod_tp_image(arch), tag=arch)
    pod = Pod(rt, arch, replicas=1, seed=0, decode_chunk=4, mesh=mesh,
              **POD_TP[arch][1])
    eng = pod.engines[0]
    tp = {"bytes": 0, "seconds": 0.0}
    if mesh is not None:
        decode = eng.decode

        def counted(*args):
            b0, s0 = mesh.stats.wire_bytes("tp"), mesh.stats.seconds
            out = decode(*args)
            tp["bytes"] += mesh.stats.wire_bytes("tp") - b0
            tp["seconds"] += mesh.stats.seconds - s0
            return out
        eng.decode = counted
    reqs = _pod_tp_requests(GenRequest, arch)
    sched = ContinuousScheduler(pod)
    sched.submit(reqs)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    sched.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    prefills = eng._c_prefill_disp.value
    out = {"tokens": [list(map(int, r.tokens)) for r in reqs],
           "admit": [r.admit_tick for r in reqs],
           "done": [r.state == "done" for r in reqs],
           "launches": launches, "prefills": prefills,
           "decode_steps": eng.decode_ticks,
           "decode_tokens": eng.tokens_generated - prefills,
           "prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
           "prefix_hits": eng.prefix_hits, "tp_decode": tp, "wall_s": wall,
           "peak": torch.cuda.max_memory_allocated(),
           "decode_dispatches": eng._c_decode_disp.value,
           "chunk": eng.chunk, "rows": [eng.rows.start, eng.rows.stop],
           "gather_bytes": (mesh.stats.wire_bytes("tokens")
                            if mesh is not None else 0)}
    for e in pod.engines:
        e.release()
    del pod, eng, sched
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return out


def phase_dist(torch, state, workdir: Path) -> None:
    import shutil
    state["dist"], state["dist_ranks"] = {}, {}
    shutil.rmtree(workdir / "train", ignore_errors=True)   # 14.4 GB
    torch.cuda.empty_cache()
    # one process on (a)'s and (d)'s llama3.2-3b image: (a)'s reference
    # (ZeRO-1 on one rank splits nothing: host's step is generic's) and
    # (d)'s
    llama_ref = _dist_reference(torch, workdir, _dist_d_image("llama3.2-3b"),
                                DIST_D_STEPS)
    failures = _dist_a(torch, state, workdir, llama_ref[0])
    b_failures, host = _dist_b(torch, state, workdir)
    failures += b_failures + _dist_c(torch, state, host)
    failures += _dist_de(torch, state, workdir, llama_ref)
    check(not failures, "dist: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# dryrun: one rank of a 256- or 512-card job traced on the meta device
# ---------------------------------------------------------------------------

# (a) the paper's Fig. 3 at its scale: deepseek-67b train_4k under fig3's
# two arms (benchmarks/fig3_collective_abi.py:27-31's VARIANTS: generic,
# and the host arm with FSDP), and llama4-scout-17b-a16e's expert-parallel
# cell, on the pod (256) and multipod (512) meshes
DRYRUN_CELLS = (("deepseek-67b", "generic", {"remat": "dots"}, ""),
                ("deepseek-67b", "host", {"remat": "dots", "fsdp": True},
                 "host"),
                ("llama4-scout-17b-a16e", "generic", {"remat": "dots"}, ""))
DRYRUN_MESHES = ("pod", "multipod")
# and serving on the model axis: deepseek-67b's prefill_32k and decode_32k
# on the pod (its 125.6 GiB of bf16 params serve on no single card) and
# mamba2-2.7b's long_500k on the multipod (one row, whole on every
# replica), each in its own process beside (a)'s
DRYRUN_SERVE = (("deepseek-67b", "prefill_32k", "pod"),
                ("deepseek-67b", "decode_32k", "pod"),
                ("mamba2-2.7b", "long_500k", "multipod"))


def _dryrun_start(workdir: Path) -> list:
    """Start (a)'s six cells, one ``python -m repro_torch.launch.dryrun``
    process each, all at once; no card visible to them."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for arch, abi, settings, tag in DRYRUN_CELLS:
        for mesh in DRYRUN_MESHES:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", "train_4k", "--mesh", mesh,
                   "--collectives", abi, "--settings", json.dumps(settings),
                   "--out", str(workdir / "dryrun")]
            if tag:
                cmd += ["--tag", tag]
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=str(workdir), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    for arch, shape, mesh in DRYRUN_SERVE:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out",
             str(workdir / "dryrun")], env=env, cwd=str(workdir),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _dryrun_cells(state, workdir: Path, procs: list) -> list[str]:
    """(a): wait for the six cells and gate their records."""
    from repro_torch.configs import get_config, get_shape_cell
    from repro_torch.launch import report
    from repro_torch.launch.analysis import model_flops
    failures = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        for line in out.strip().splitlines():
            if line.startswith(("[ok", "[FAILED", "[skip")):
                log(f"dryrun: (a) {line}")
        if p.returncode != 0:
            failures.append(f"(a) {p.args[4]} {p.args[8]}: exit "
                            f"{p.returncode}: {out[-500:]}")
    recs = {}
    for arch, abi, _, tag in DRYRUN_CELLS:
        for mesh in DRYRUN_MESHES:
            path = (workdir / "dryrun"
                    / f"{arch}__train_4k__{mesh}{'-' + tag if tag else ''}"
                    ".json")
            rec = json.loads(path.read_text()) if path.exists() else {}
            recs[(arch, abi, mesh)] = rec
            if rec.get("status") != "ok":
                failures.append(f"(a) {arch} {abi} {mesh}: "
                                f"{rec.get('status')} {rec.get('error')}")
    ok_recs = [r for r in recs.values() if r.get("status") == "ok"]
    for line in report.table(ok_recs).splitlines():
        log(f"dryrun: (a) {line}")
    for (arch, abi, mesh), rec in recs.items():
        if rec.get("status") != "ok":
            continue
        rl, cost = rec["roofline"], rec["cost"]
        want = model_flops(get_config(arch), get_shape_cell("train_4k"))
        labels = cost["collective_bytes_by_label"]
        cross = cost["cross_pod_bytes_per_device"]
        ok = (rl["model_flops_global"] == want
              and 0 < rl["useful_flops_fraction"] <= 1
              and 0 < rl["roofline_fraction"] <= 1
              and (cross > 0 if mesh == "multipod" else cross == 0))
        log(f"dryrun: (a) {arch} train_4k {mesh} {abi}"
            f"{' + fsdp' if rec['settings'].get('fsdp') else ''}: wire "
            f"bytes a device {cost['wire_bytes_per_device']:,} ({labels}), "
            f"cross-pod {cross:,}; model FLOPs {rl['model_flops_global']:.4e}"
            f" (model_flops {want:.4e}); kernel calls {rec['kernel_calls']};"
            f" resident {rec['memory']['resident_bytes_per_device'] / 2**30:.2f}"
            f" GiB a rank; traced in {rec['seconds']['lower']:.1f} s "
            f"{'ok' if ok else 'FAIL'} (H100 data-sheet constants; "
            f"{state['card']})")
        if not ok:
            failures.append(f"(a) {arch} {abi} {mesh}: gates")
    # Fig. 3's two arms: the JAX package's dry run puts host + fsdp above
    # generic in wire bytes on both meshes and in cross-pod bytes at
    # multipod (tests/test_torch_dryrun.py holds the port's ordering to
    # it at 2 layers); the port's must stand on the same side
    for mesh, key in (("pod", "wire_bytes_per_device"),
                      ("multipod", "wire_bytes_per_device"),
                      ("multipod", "cross_pod_bytes_per_device")):
        gen = recs.get(("deepseek-67b", "generic", mesh), {})
        host = recs.get(("deepseek-67b", "host", mesh), {})
        if not gen.get("status") == host.get("status") == "ok":
            continue
        g, h = gen["cost"][key], host["cost"][key]
        ok = h > g
        log(f"dryrun: (a) deepseek-67b {mesh} {key}: host + fsdp {h:,} / "
            f"generic {g:,} = {h / g:.3f} (the JAX package's arms: host "
            f"above generic) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"(a) deepseek-67b {mesh} {key}: host {h} "
                            f"not above generic {g}")
    state["dryrun"]["cells"] = {f"{a} {b} {m}": r
                                for (a, b, m), r in recs.items()}
    return failures + _dryrun_serve_cells(state, workdir)


def _dryrun_serve_cells(state, workdir: Path) -> list[str]:
    """(a)'s serve cells: each ``ok``, ``fits_hbm`` the resident bytes
    against one card's, and the rank's part of the cache (of its KV
    leaves, where the arch has attention) the whole over the model axis's
    16 and over the replicas where they divide the batch."""
    from repro_torch.configs import get_shape_cell
    from repro_torch.launch.analysis import HBM_PER_CHIP
    failures = []
    for arch, shape, mesh in DRYRUN_SERVE:
        path = workdir / "dryrun" / f"{arch}__{shape}__{mesh}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        if rec.get("status") != "ok":
            failures.append(f"(a) {arch} {shape} {mesh}: "
                            f"{rec.get('status')} {rec.get('error')}")
            continue
        mem, cache = rec["memory"], rec["cache"]
        reps = rec["n_devices"] // 16
        batch = get_shape_cell(shape).global_batch
        rows = reps if batch % reps == 0 else 1
        key = "kv_bytes" if cache["kv_bytes"] else "bytes"
        ok = (mem["fits_hbm"] == (mem["resident_bytes_per_device"]
                                  <= HBM_PER_CHIP)
              and cache[key + "_per_device"] * 16 * rows == cache[key])
        log(f"dryrun: (a) {arch} {shape} {mesh}: {key.replace('_', ' ')} "
            f"{cache[key]:,} whole, {cache[key + '_per_device']:,} a rank "
            f"(1/16 over the model axis x 1/{rows} over the rows); resident "
            f"{mem['resident_bytes_per_device'] / 2**30:.2f} GiB a rank, "
            f"fits {mem['fits_hbm']}; kernel calls {rec['kernel_calls']}; "
            f"roofline {rec['roofline']['dominant']} "
            f"{max(rec['roofline'][k] for k in ('compute_s', 'memory_s', 'collective_s')):.4e} s;"
            f" probes {len(rec['probes'])} stages; traced in "
            f"{rec['seconds']['lower']:.1f} s {'ok' if ok else 'FAIL'} "
            f"(H100 data-sheet constants; {state['card']})")
        state["dryrun"]["cells"][f"{arch} {shape} {mesh}"] = rec
        if not ok:
            failures.append(f"(a) {arch} {shape} {mesh}: gates {cache}")
    return failures


def _dryrun_ranks(state) -> list[str]:
    """(b): the dist phase's jobs on rank 0 of 2 fake ranks, their bytes a
    step by label and operation and kernel calls a step against what the
    ranks counted in this run."""
    from repro_torch.core.container import Container
    from repro_torch.core.imagefile import parse_imagefile
    from repro_torch.dist.mesh import fake_job, make_mesh
    failures = []
    ranks = state.get("dist_ranks", {})
    if len(ranks) != len(DIST_B) + len(DIST_D) + len(DIST_E):
        failures.append(f"(b) the dist phase recorded {sorted(ranks)}")
    for name, run in ranks.items():
        steps = run["steps"]
        with fake_job(2):
            mesh = make_mesh(run["mesh"], ("data", "model"))
            c = Container(parse_imagefile(run["text"]), platform="local",
                          mesh=mesh, device="meta")
            low = c.lower_step("train")
        got = low.collectives.bytes
        # the checkpoint store's gathers (ZeRO-1 parts made whole for a
        # save) are the run's, not a step's: the dry run traces one step
        want = {label: {op: n / steps for op, n in by_op.items()}
                for label, by_op in run["by_op"].items()
                if label != "checkpoint"}
        calls = low.counter.kernel_calls
        want_calls = {k: n / steps for k, n in run["launches"].items() if n}
        ok = got == want and calls == want_calls
        ckpt = run["by_op"].get("checkpoint")
        log(f"dryrun: (b) {name} on 2 fake ranks, mesh {run['mesh']}: "
            f"bytes a step {got} (ranks {want}"
            f"{f'; their checkpoint saves over the run {ckpt}' if ckpt else ''}"
            f"); kernel calls a step "
            f"{calls} (ranks' launches {want_calls}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"(b) {name}: {got} vs {want}, {calls} vs "
                            f"{want_calls}")
    return failures


def _op_diffs(a, b) -> dict:
    return {op: (a.by_op.get(op), b.by_op.get(op))
            for op in sorted(set(a.by_op) | set(b.by_op))
            if a.by_op.get(op) != b.by_op.get(op)}


def _dryrun_real_step(torch, state) -> list[str]:
    """(c): one real step on the card under the counter against its meta
    trace; the full-width step's trace against the train phase."""
    from repro_torch.core.container import Container
    from repro_torch.core.imagefile import parse_imagefile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.core.trace import trace
    from repro_torch.launch import analysis
    failures = []
    text = DIST_IMAGEFILE.format(arch="llama3.2-3b",
                                 layers=f" n_layers={DIST_B_LAYERS}",
                                 collectives="generic")
    c = Container(parse_imagefile(text))
    params = c.init_params(0)
    opt = c.init_opt_state(params)
    step = c.train_step_fn(donate=True)
    data = SyntheticLM(DataConfig(vocab_size=c.arch.vocab_size,
                                  seq_len=c.cell.seq_len,
                                  global_batch=c.cell.global_batch, seed=0))
    # the batch as the step keeps it (int64 on the card), made before the
    # counter, as a meta trace's inputs are
    batch = {k: torch.as_tensor(v).long().to(c.device)
             for k, v in data.batch(0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    real, _ = trace(step, (params, opt, batch), c.mesh)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = _main_path_counts(state)
    del params, opt, batch, step
    torch.cuda.empty_cache()
    meta = Container(parse_imagefile(text), device="meta").lower_step()
    r, m = real.counter, meta.counter
    diffs = _op_diffs(r, m)
    other_path = any(a is None or b is None or a[2] != b[2]
                     for a, b in diffs.values())
    want_k2 = {"flash_attention_fwd": DIST_B_LAYERS * 2,
               "flash_attention_bwd": DIST_B_LAYERS}
    launched = {k: n for k, n in launches.items() if n}
    ok = (r.flops == m.flops and r.kernel_calls == m.kernel_calls == want_k2
          and launched == want_k2 and (r.bytes == m.bytes or other_path))
    est = meta.memory()["resident_bytes"]
    log(f"dryrun: (c) one step of llama3.2-3b at {DIST_B_LAYERS} layers on "
        f"the card under the counter vs its meta trace: FLOPs "
        f"{r.flops:,} / {m.flops:,}; bytes {r.bytes:,} / {m.bytes:,}; "
        f"kernel calls {r.kernel_calls} / {m.kernel_calls}, launches "
        f"{launched}; operators that differ (flops, bytes, calls) card / "
        f"meta {diffs}; resident estimate {est / 2**30:.2f} GiB, measured "
        f"peak {peak / 2**30:.2f} GiB, ratio {est / peak:.3f} "
        f"{'ok' if ok else 'FAIL'} [{state['card']}]")
    if not ok:
        failures.append(f"(c) real step vs trace: {diffs}")

    # the train phase's full-width step: its bound beside the measured
    # median, its K2 calls, and whether it fits the card
    full = Container(parse_imagefile(TRAIN_IMAGEFILE), device="meta")
    low = full.lower_step()
    rl = analysis.roofline(low.cost(), analysis.model_flops(full.arch,
                                                            full.cell), 1)
    mem = low.memory()
    run = state.get("train", {}).get(f"llama run {' '.join(TRAIN_RUN)}",
                                     {})
    measured = run.get("peak_gib", float("nan")) * 2**30
    fits = mem["resident_bytes"] <= analysis.HBM_PER_CHIP
    total = torch.cuda.get_device_properties(0).total_memory
    want_k2 = {"flash_attention_fwd": full.arch.n_layers * 2,
               "flash_attention_bwd": full.arch.n_layers}
    ok = (low.counter.kernel_calls == want_k2 and bool(run)
          and fits == (measured <= analysis.HBM_PER_CHIP))
    log(f"dryrun: (c) llama3.2-3b full width, {full.arch.n_layers} layers, "
        f"2 x 2048 tokens, remat=full: "
        f"bound {rl.bound_s:.4f} s ({rl.dominant}: compute "
        f"{rl.compute_s:.4f}, memory {rl.memory_s:.4f} s at H100 data-sheet "
        f"peaks) beside the train phase's median step "
        f"{run.get('step_s', float('nan')):.4f} s; FLOPs "
        f"{low.counter.flops:.4e}, bytes {low.counter.bytes:.4e}; K2 calls "
        f"{low.counter.kernel_calls} (want {want_k2}); resident estimate "
        f"{mem['resident_bytes'] / 2**30:.2f} GiB (arguments "
        f"{mem['argument_bytes'] / 2**30:.2f}, temp "
        f"{mem['temp_bytes'] / 2**30:.2f}) vs the train phase's measured "
        f"peak {measured / 2**30:.2f} GiB, ratio "
        f"{mem['resident_bytes'] / measured:.3f}; fits {fits} "
        f"(HBM_PER_CHIP {analysis.HBM_PER_CHIP:,}, the card's total_memory "
        f"{total:,}) {'ok' if ok else 'FAIL'} [{state['card']}]")
    state["dryrun"]["real_step"] = dict(
        flops=r.flops, bytes=[r.bytes, m.bytes], diffs=diffs,
        est_gib=est / 2**30, peak_gib=peak / 2**30,
        full_bound_s=rl.bound_s, full_step_s=run.get("step_s"),
        full_est_gib=mem["resident_bytes"] / 2**30,
        full_peak_gib=measured / 2**30)
    if not ok:
        failures.append("(c) the full-width step's trace")
    return failures


def phase_dryrun(torch, state, workdir: Path) -> None:
    """(a) in six processes while (b) and (c) run here."""
    state["dryrun"] = {}
    t0 = time.perf_counter()
    procs = _dryrun_start(workdir)
    try:
        failures = _dryrun_ranks(state)
        failures += _dryrun_real_step(torch, state)
        failures += _dryrun_cells(state, workdir, procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    took = time.perf_counter() - t0
    log(f"dryrun: {took:.1f} s by the phase's clock")
    check(not failures, "dryrun: " + "; ".join(failures))


def _record_k2_bwd(state) -> None:
    """Every in-process call of K2's backward wrapper, for the run: its
    shape (``_k2_key``) appended to ``state["k2_bwd_calls"]``, which each
    phase's end reads and clears (a rank records its own: ``tp_worker``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    real = fa_ops.flash_attention_bwd_cuda

    def k2_bwd(q, k, v, out, lse, dout, *, causal=True, window=0, **kw):
        state["k2_bwd_calls"].append(_k2_key(q, k, window, causal))
        return real(q, k, v, out, lse, dout, causal=causal, window=window,
                    **kw)
    fa_ops.flash_attention_bwd_cuda = k2_bwd


def main() -> int:
    if sys.argv[1:2] == ["--tp-worker"]:
        return tp_worker(sys.argv[2])
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

    state = {"records": {}, "launches": {}, "card": "", "k2_bwd_calls": []}
    _record_k2_bwd(state)
    failed = []
    t_start = time.perf_counter()
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
                elif phase == "fig5":
                    phase_fig5(torch, state, workdir)
                elif phase == "parity":
                    phase_parity(torch, state, workdir)
                elif phase == "serve":
                    phase_serve(torch, state, workdir)
                elif phase == "batch":
                    phase_batch(torch, state, workdir)
                elif phase == "cli":
                    phase_cli(torch, state, workdir)
                elif phase == "examples":
                    phase_examples(torch, state, workdir)
                elif phase == "fabric":
                    phase_fabric(torch, state, workdir)
                elif phase == "train":
                    timer = timer or Timer(torch)
                    phase_train(torch, state, timer, workdir)
                elif phase == "dist":
                    phase_dist(torch, state, workdir)
                elif phase == "dryrun":
                    phase_dryrun(torch, state, workdir)
            except Exception as e:          # report every phase, then fail
                failed.append(phase)
                log(f"FAIL {phase}: {type(e).__name__}: {e}")
                if not isinstance(e, PhaseError):
                    import traceback
                    traceback.print_exc(file=sys.stdout)
            unheld = (set(state["k2_bwd_calls"])
                      - state.get("k2_bwd_checked", set()))
            state["k2_bwd_calls"].clear()
            if unheld and phase not in failed:
                failed.append(phase)
                log(f"FAIL {phase}: K2's backward ran at shapes the kernels "
                    f"phase did not hold to its plain version: "
                    f"{sorted(unheld)}")
            log(f"== {phase} {'failed' if phase in failed else 'passed'} "
                f"in {time.perf_counter() - t0:.1f} s")
    log(f"chip_smoke: {len(PHASES)} phases in "
        f"{time.perf_counter() - t_start:.1f} s")

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
