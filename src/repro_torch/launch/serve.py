"""Serving driver: a thin CLI over the Pod orchestrator.

Continuous (default): a Pod of Container replicas serves staggered
variable-length requests via continuous batching:

  PYTHONPATH=src python -m repro_torch.launch.serve --image <tag|Imagefile> \
      --replicas 2 --slots 8 --requests 32 --gen 32

Multi-pod (--pods N): the same trace served by a PodRouter fronting N
pods (each its own scheduler + queue), with --policy shortest-queue
(load-aware, default) or consistent-hash (rid session affinity).

Static (--mode static): the pre-orchestrator baseline -- one fixed batch,
prefill + greedy decode loop -- kept as the fig6 comparison point. Both
modes build their steps through the Container serve path and its
CompileCache, so a second replica reuses the built steps.

Both modes replay the SAME deterministic trace (prompts, budgets, and --
for frontend-embedding archs like musicgen/internvl2 -- per-request
audio/vision prefix embeddings), and both return ``request_tokens``:
continuous and static produce identical tokens request-for-request.

PyTorch port of ``repro.launch.serve``. Without ``--platform`` the pods and
the static container run on the image's MESH layer (``local`` = cuda:0);
``--platform cpu`` runs on the host CPU. The cross-host fabric
(``--fabric loopback|proc``) is not ported yet and raises, naming ROADMAP.md
Queue 1 item 8.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.runtime import Runtime

_FABRIC = ("--fabric {}: the cross-host fabric (fabric.py, fabric_worker.py) "
           "is not ported yet (ROADMAP.md Queue 1 item 8: fleet)")


def _tail_budgets(gen: int, n: int) -> list[int]:
    """Heavy-tailed decode budgets: most requests short, one in four runs
    the full budget (the production shape that makes a static wave idle on
    its longest member). One helper so both serving modes -- and the fig6
    benchmark -- replay the SAME trace."""
    tail = [2, max(2, gen // 8), max(2, gen // 4), gen]
    return [tail[i % len(tail)] for i in range(n)]


def _frontend_width(cfg) -> int:
    return cfg.frontend_len if cfg.frontend else 0


def _build_requests(args, cfg, rng):
    """Deterministic staggered, variable-length trace.

    Frontend-embedding archs (musicgen/internvl2) get a per-request
    modality prefix: a deterministic stand-in for precomputed EnCodec
    frames / InternViT patch embeddings (the frontends are stubs per the
    assignment). Both serve modes replay this SAME trace, so continuous and
    static produce identical tokens request-for-request.

    ``--shared-prefix N`` prepends ONE fixed N-token block (a fleet-wide
    system prompt) to every request and declares it via
    ``GenRequest.prefix_len`` -- the trace the prefix page cache and the
    prefix-hash router policy are measured on. The block is drawn from the
    rng FIRST, so the per-request tail of the trace is identical whether
    or not caching is enabled (same flags -> bitwise-same trace).

    ``--batch-every N`` tags every Nth request (rid % N == N-1) as the
    ``batch`` QoS class -- sheddable under overload, preemptible under
    pool pressure; 0 (default) leaves the whole trace interactive.
    ``--deadline-ticks D`` puts an admission deadline on the batch
    requests (the tier the SLO policy may drop). Neither flag changes the
    prompts or budgets, so QoS on/off replays the same token trace."""
    from repro_torch.orchestrator import GenRequest
    reqs = []
    budgets = _tail_budgets(args.gen, args.requests)
    fe_len = _frontend_width(cfg)
    shared = max(0, int(getattr(args, "shared_prefix", 0)))
    batch_every = max(0, int(getattr(args, "batch_every", 0)))
    deadline = getattr(args, "deadline_ticks", None)
    sys_prompt = rng.integers(0, cfg.vocab_size, shared) if shared else None
    for i in range(args.requests):
        plen = int(args.prompt_len * (0.5 + 0.5 * ((i * 7919) % 97) / 96))
        fe = (0.02 * rng.standard_normal((fe_len, cfg.d_model)).astype(
            np.float32) if fe_len else None)
        prompt = rng.integers(0, cfg.vocab_size, max(1, plen))
        if shared:
            prompt = np.concatenate([sys_prompt, prompt])
        is_batch = batch_every and i % batch_every == batch_every - 1
        reqs.append(GenRequest(
            rid=i,
            prompt=prompt,
            max_new_tokens=budgets[i],
            arrival=i // max(1, getattr(args, "arrive_per_tick", 8)),
            frontend=fe,
            prefix_len=shared,
            priority="batch" if is_batch else "interactive",
            deadline_ticks=deadline if is_batch else None))
    return reqs


def _arch_config(rt: Runtime, image):
    """The image's resolved ModelConfig (without running a container)."""
    from repro_torch.configs import get_config
    cfg = (image if not isinstance(image, str) else rt.pull(image)).config()
    return get_config(cfg["arch"]["name"], **cfg["arch"].get("overrides", {}))


def _pod_kwargs(args, cfg) -> dict:
    """Pod constructor kwargs sized for the trace -- shared by every fleet
    member, whether the pod is built here or inside a fabric worker
    process (the kwargs are JSON-serializable by construction)."""
    # per-request span: frontend prefix + shared system prompt + prompt +
    # gen + chunk-overshoot
    shared = max(0, int(getattr(args, "shared_prefix", 0)))
    max_len = _frontend_width(cfg) + shared + args.prompt_len + args.gen + 8
    if getattr(args, "paged", False):
        # paged: max_len is only the per-request span; double it so long
        # requests fit, and size the pool to the contiguous bank's HBM
        return dict(replicas=args.replicas, n_slots=args.slots,
                    max_len=2 * max_len, platform=args.platform,
                    seed=args.seed, paged=True, page_size=args.page_size,
                    n_pages=args.slots * (-(-max_len // args.page_size)) + 1,
                    prefix_cache=bool(getattr(args, "prefix_cache", False)),
                    spill_pages=getattr(args, "spill_pages", 0))
    return dict(replicas=args.replicas, n_slots=args.slots,
                max_len=max_len, platform=args.platform, seed=args.seed)


def _make_pod(rt: Runtime, image, args, cfg):
    """One serving pod sized for the trace (shared by every fleet member)."""
    from repro_torch.orchestrator import Pod
    return Pod(rt, image, **_pod_kwargs(args, cfg))


def serve_continuous(rt: Runtime, image, args) -> dict:
    from repro_torch.orchestrator import ContinuousScheduler, PodRouter
    from repro_torch.orchestrator.obs import decomposition, export_chrome
    from repro_torch.orchestrator.telemetry import latency_summary
    cfg = _arch_config(rt, image)
    n_pods = max(1, int(getattr(args, "pods", 1)))
    pods = [_make_pod(rt, image, args, cfg) for _ in range(n_pods)]
    if n_pods > 1:
        # fleet: one router surface over per-pod schedulers/queues
        driver = PodRouter(pods,
                           policy=getattr(args, "policy", "shortest-queue"),
                           fairness_cap=args.fairness_cap,
                           shed_queue_depth=getattr(
                               args, "shed_queue_depth", None),
                           shed_ttft_p99=getattr(
                               args, "shed_ttft_p99", None))
    else:
        driver = ContinuousScheduler(pods[0],
                                     fairness_cap=args.fairness_cap)
    rng = np.random.default_rng(args.seed)
    reqs = _build_requests(args, cfg, rng)

    t0 = time.perf_counter()
    driver.submit(reqs)
    done = driver.run()
    wall = time.perf_counter() - t0
    # terminal phase: ps stays honest after exit
    if n_pods > 1:
        driver.write_state(final=True)      # also finalizes member pods
    else:
        pods[0].write_state(final=True)

    engines = [e for p in pods for e in p.engines]
    toks = sum(len(r.tokens) for r in done)
    dec_s = sum(e.decode_s for e in engines)
    pre_s = sum(e.prefill_s for e in engines)
    ticks = sum(e.decode_ticks for e in engines)
    out = {
        "mode": "continuous",
        "pods": n_pods,
        "requests": len(done),
        "tokens": toks,
        "wall_s": wall,
        "decode_s": dec_s,
        "prefill_s": pre_s,
        "decode_ticks": ticks,
        "decode_tok_per_s": toks / dec_s if dec_s else 0.0,
        "prefill_positions": sum(e.prefill_positions for e in engines),
        "prefix_cache": {
            "enabled": any(e.prefix_cache for e in engines),
            "hits": sum(e.prefix_hits for e in engines),
            "misses": sum(e.prefix_misses for e in engines),
            "tokens_saved": sum(e.prefix_tokens_saved for e in engines),
            # radix-registry taxonomy + spill-tier traffic
            "ancestor_hits": sum(e.prefix_ancestor_hits for e in engines),
            "partial_hits": sum(e.prefix_partial_hits for e in engines),
            "spills": sum(e.pool.spills for e in engines
                          if getattr(e, "paged", False)),
            "restores": sum(e.pool.restores for e in engines
                            if getattr(e, "paged", False)),
        },
        "tokens_wasted": sum(e.tokens_wasted for e in engines),
        # QoS accounting: page-level preemptions/resumes on the engines,
        # sheds at the router (overload) and schedulers (deadline)
        "preemptions": sum(e.preemptions for e in engines),
        "resumes": sum(e.resumes for e in engines),
        "shed": (driver.shed_total if n_pods > 1
                 else len(driver.shedded)),
        # nearest-rank percentiles, measured from request ARRIVAL (the
        # trace stagger is offered load, not serving latency)
        **latency_summary(done),
        "request_tokens": {r.rid: list(r.tokens) for r in done},
        "pod": pods[0].status() if n_pods == 1 else None,
    }
    # TTFT / inter-token-latency decomposition derived from the span logs
    # (not re-measured): the same numbers a trace viewer would show
    buffers = (driver.trace_buffers() if n_pods > 1
               else [pods[0].trace])
    out["decomposition"] = decomposition(buffers)
    if getattr(args, "batch_every", 0):
        # mixed-QoS trace: the per-class split is the fig10 deliverable
        out["decomposition_interactive"] = decomposition(
            buffers, priority="interactive")
        out["decomposition_batch"] = decomposition(buffers, priority="batch")
    trace_path = getattr(args, "trace", None)
    if trace_path:
        trace = export_chrome(buffers, trace_path)
        print(f"[serve] trace: {len(trace['traceEvents'])} events -> "
              f"{trace_path} (open in Perfetto / chrome://tracing)")
    if n_pods > 1:
        out["fleet"] = driver.status()
        print(f"[serve] fleet={driver.router_id} policy={driver.policy} "
              f"pods={n_pods} image={pods[0].image.short_digest} "
              f"replicas={args.replicas} slots={args.slots}")
    else:
        print(f"[serve] pod={pods[0].pod_id} "
              f"image={pods[0].image.short_digest} "
              f"replicas={args.replicas} slots={args.slots}")
    # a run with no completions has no latency: render '-', never a fake 0
    if out["latency_count"]:
        p50, p99 = out["p50_latency_ticks"], out["p99_latency_ticks"]
    else:
        p50 = p99 = "-"
    print(f"[serve] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"(decode {out['decode_tok_per_s']:.0f} tok/s over {ticks} ticks; "
          f"p50 {p50} / p99 {p99} ticks)")
    d = out["decomposition"]
    if d["latency_count"]:
        print(f"[serve] ttft p50 {d['ttft_p50_ticks']} / "
              f"p99 {d['ttft_p99_ticks']} ticks; "
              f"itl p50 {d['itl_p50_ticks']:.2f} / "
              f"p99 {d['itl_p99_ticks']:.2f} ticks/tok")
    pc = out["prefix_cache"]
    if pc["enabled"]:
        print(f"[serve] prefix cache: {pc['hits']} hits "
              f"({pc['ancestor_hits']} ancestor, {pc['partial_hits']} "
              f"partial) / {pc['misses']} misses, "
              f"{pc['tokens_saved']} prefill tokens skipped")
        if pc["spills"] or pc["restores"]:
            print(f"[serve] spill tier: {pc['spills']} spills / "
                  f"{pc['restores']} restores")
    if out["preemptions"] or out["shed"]:
        print(f"[serve] qos: {out['preemptions']} preemptions / "
              f"{out['resumes']} resumes, {out['shed']} shed")
    return out


def serve_static(rt: Runtime, image, args) -> dict:
    """Fixed-batch baseline THROUGH the container compile path.

    Replays the SAME trace as continuous mode, one wave of ``slots``
    requests at a time: wave prefill with per-row prompt (and frontend
    prefix) lengths, then a greedy decode loop of the full ``gen`` budget
    for every wave member -- the static batch cannot release a finished
    slot, which is exactly the waste fig6 measures. Tokens are identical
    to continuous mode request-for-request."""
    c = rt.run(image, platform=args.platform)
    cfg = c.arch
    B, P, G = args.slots, args.prompt_len, args.gen
    F = _frontend_width(cfg)
    cache_len = F + P + G + 1
    shapes = dict(batch=B, prompt_len=P, cache_len=cache_len)
    if F:
        shapes["frontend_len"] = F
    prefill = c.compile_serve_step("prefill_slot", **shapes)
    generate = c.compile_serve_step("generate", batch=B, cache_len=cache_len,
                                    gen_steps=G, per_row=True)
    rng = np.random.default_rng(args.seed)
    reqs = _build_requests(args, cfg, rng)
    params = c.init_params(args.seed)

    def dev(x):
        return torch.as_tensor(x, device=c.device)

    def sync():
        if c.device.type == "cuda":
            torch.cuda.synchronize(c.device)

    toks_useful = 0
    t_pre = t_dec = 0.0
    waves = 0
    request_tokens: dict[int, list[int]] = {}
    t0 = time.perf_counter()
    for lo in range(0, len(reqs), B):
        wave = reqs[lo:lo + B]
        toks = np.zeros((B, P), np.int32)
        lens = np.ones(B, np.int32)          # pad rows: 1 real token (row 0)
        fls = np.zeros(B, np.int32)
        fe = np.zeros((B, F, cfg.d_model), np.float32) if F else None
        for j, r in enumerate(wave):
            toks[j, :r.prompt_len] = r.prompt
            lens[j] = r.prompt_len
            if F and r.frontend is not None:
                fe[j, :r.frontend_len] = r.frontend
                fls[j] = r.frontend_len
        fe_args = ((dev(fe).to(c.cache_dtype), dev(fls)) if F else ())
        t1 = time.perf_counter()
        first, cache = prefill(params, dev(toks), dev(lens), *fe_args)
        sync()
        t_pre += time.perf_counter() - t1
        t1 = time.perf_counter()
        # the static batch cannot release a finished slot: it decodes the
        # full G steps for everyone in the wave, each row at its own
        # prefix+prompt start position
        gen_toks, _ = generate(params, cache, first[:, None],
                               dev(fls + lens))
        sync()
        t_dec += time.perf_counter() - t1
        first_np, gen_np = first.cpu().numpy(), gen_toks.cpu().numpy()
        for j, r in enumerate(wave):
            # same convention as continuous mode: a budget of g counts g
            # tokens (the prefill-sampled first token is inside the budget)
            g = min(r.max_new_tokens, G)
            request_tokens[r.rid] = (
                [int(first_np[j])] + [int(t) for t in gen_np[j, :g - 1]])
            toks_useful += g
        waves += 1
    wall = time.perf_counter() - t0
    out = {
        "mode": "static",
        "requests": len(reqs),
        "tokens": toks_useful,
        "wall_s": wall,
        "decode_s": t_dec,
        "prefill_s": t_pre,
        "decode_ticks": waves * G,
        "decode_tok_per_s": toks_useful / t_dec if t_dec else 0.0,
        "request_tokens": request_tokens,
    }
    print(f"[serve] static baseline: {len(reqs)} requests in {waves} "
          f"waves of {B}: {toks_useful} useful tokens, decode "
          f"{out['decode_tok_per_s']:.0f} tok/s ({t_dec:.2f}s)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--mode", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--pods", type=int, default=1,
                    help="pods behind a PodRouter (>1 = multi-pod fleet)")
    ap.add_argument("--policy",
                    choices=("shortest-queue", "consistent-hash",
                             "prefix-hash"),
                    default="shortest-queue",
                    help="router placement policy (--pods > 1); prefix-hash "
                         "places on the shared-prefix digest so cache hits "
                         "land on the pod that owns the pages")
    ap.add_argument("--fabric", choices=("none", "loopback", "proc"),
                    default="none",
                    help="serve over the cross-host fabric (not ported "
                         "yet: raises, naming ROADMAP.md Queue 1 item 8)")
    ap.add_argument("--slots", type=int, default=8,
                    help="KV slots per replica (static: the batch size)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--arrive-per-tick", type=int, default=8,
                    help="staggered arrivals: requests arriving per tick")
    ap.add_argument("--fairness-cap", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (shared page pool + Pallas "
                         "paged-attention) instead of per-slot slabs")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="copy-on-write prefix page sharing for requests "
                         "declaring a shared leading block (implies --paged)")
    ap.add_argument("--spill-pages", type=int, default=0,
                    help="host-RAM spill tier for evicted prefix pages: "
                         "0 disables, -1 is unbounded, N caps the store at "
                         "N pages (requires --prefix-cache)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one fixed N-token system prompt to every "
                         "request (the shared-prefix trace)")
    ap.add_argument("--batch-every", type=int, default=0,
                    help="tag every Nth request as the batch QoS class "
                         "(sheddable + preemptible); 0 = all interactive")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="admission deadline for batch requests: shed if "
                         "not admitted within D ticks of arrival")
    ap.add_argument("--shed-queue-depth", type=int, default=None,
                    help="router shedding threshold (--pods > 1): shed "
                         "batch submissions when every fitting pod's "
                         "queue_depth gauge is at or over N")
    ap.add_argument("--shed-ttft-p99", type=int, default=None,
                    help="router shedding threshold (--pods > 1): shed "
                         "batch submissions when every fitting pod's "
                         "ttft p99 is at or over N ticks")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export the run's request-lifecycle spans as "
                         "Chrome trace-event JSON (open in Perfetto)")
    ap.add_argument("--root", default=".stevedore")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.prefix_cache:
        args.paged = True           # prefix sharing is page-granular
    if args.spill_pages:
        if not args.prefix_cache:
            ap.error("--spill-pages requires --prefix-cache (the spill "
                     "tier holds evicted prefix-registry pages)")
        if args.spill_pages < 0:
            args.spill_pages = None     # unbounded host store
    if args.mode == "static" and args.fabric != "none":
        ap.error("--fabric applies to continuous mode only")
    if args.mode == "static" and args.pods > 1:
        # never let a "static fleet" silently serve from one host: the
        # static baseline has no router tier, and comparing it against an
        # N-pod continuous run would be N-times biased
        ap.error("--pods applies to continuous mode only "
                 "(static is the single-host baseline)")

    rt = Runtime(args.root)
    # a registry ref is passed through as a ref so the Pod stays
    # tag-upgradable (RollingDeployer re-resolves it); an Imagefile is built
    image = (rt.build(Path(args.image).read_text())
             if Path(args.image).exists() else args.image)
    if args.mode == "static":
        return serve_static(rt, image, args)
    if args.fabric != "none":
        raise NotImplementedError(_FABRIC.format(args.fabric))
    return serve_continuous(rt, image, args)


if __name__ == "__main__":
    main()
