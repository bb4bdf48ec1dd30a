"""stevedore: the docker-shaped CLI over the Runtime (paper §3.2).

  PYTHONPATH=src python -m repro_torch.cli build -t stable Imagefile
  PYTHONPATH=src python -m repro_torch.cli images
  PYTHONPATH=src python -m repro_torch.cli history stable
  PYTHONPATH=src python -m repro_torch.cli run stable --steps 10 [--resume]
  PYTHONPATH=src python -m repro_torch.cli serve stable --replicas 2 --slots 8
  PYTHONPATH=src python -m repro_torch.cli serve stable --pods 2 --fabric proc
  PYTHONPATH=src python -m repro_torch.cli ps
  PYTHONPATH=src python -m repro_torch.cli top
  PYTHONPATH=src python -m repro_torch.cli tag <digest> prod

The paper's observation (§3.2) is that raw runtime CLIs are too low-level
for scientists, so projects ship a wrapper (`fenicsproject notebook ...`).
This is that wrapper.

PyTorch port of ``repro.cli``: the same commands and output over the port's
Runtime, training and serving on the card unless ``--platform cpu`` is
given. ``run`` also takes ``--ckpt-every`` and ``--keep`` (the
checkpoint period of ``launch/train.py`` and the checkpoints kept on
disk). ``lint`` is
not ported yet and raises, naming ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.core.runtime import Runtime

_LINT = ("`lint` is not ported yet (ROADMAP.md Queue 1 item 12: tooling); "
         "run the JAX package's `repro lint`, which scans src/repro_torch "
         "too")


def _pid_alive(pid: int) -> bool:
    import os
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except ValueError:
        return False
    except PermissionError:
        return True        # exists, owned by another user
    return True


def cmd_build(rt: Runtime, args) -> int:
    text = Path(args.imagefile).read_text()
    image = rt.build(text, tag=args.tag)
    print(f"built {image.short_digest}" + (f" (tag: {args.tag})" if args.tag else ""))
    for digest, kind, summary in image.history():
        print(f"  {digest} {kind:12s} {summary}")
    return 0


def cmd_images(rt: Runtime, args) -> int:
    for rec in rt.images():
        tags = ",".join(rec["tags"]) or "<none>"
        print(f"{rec['digest']}  {tags}")
    return 0


def cmd_history(rt: Runtime, args) -> int:
    image = rt.pull(args.ref)
    for digest, kind, summary in image.history():
        print(f"{digest} {kind:12s} {summary}")
    return 0


def cmd_tag(rt: Runtime, args) -> int:
    rt.registry.tag(args.ref, args.tag)
    print(f"{args.tag} -> {rt.registry.resolve(args.tag)[:12]}")
    return 0


def _snap_latency(snap: dict, name: str = "latency_ticks"):
    """('-', '-') when the snapshot holds no completed samples --
    nearest_rank's 0-for-empty must never render as a 0-tick latency."""
    from repro_torch.orchestrator.obs.metrics import snapshot_percentile
    p50 = snapshot_percentile(snap, name, 50)
    p99 = snapshot_percentile(snap, name, 99)
    return (("-", "-") if p50 is None else (p50, p99))


def cmd_ps(rt: Runtime, args) -> int:
    for rec in rt.ps():
        print(f"{rec['id'][:24]:26s} {rec['arch']:24s} "
              f"{rec.get('cell') or '-':12s} {rec['platform']:9s} "
              f"{rec.get('abi','')}")
    pods_dir = rt.root / "pods"
    if pods_dir.exists():
        for p in sorted(pods_dir.glob("*.json")):
            try:
                pod = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                continue               # mid-write or corrupt; skip, not crash
            if not isinstance(pod, dict):
                continue
            phase = pod.get("phase", "-")
            pid = pod.get("pid")
            if pid is not None and not _pid_alive(pid):
                phase = "exited"        # stale snapshot of a dead process
            if pod.get("kind") == "router":
                # the fleet reads as one unit: one router line; member pods
                # follow as their own records (marked router=<id>)
                draining = len(pod.get("draining", []))
                # per-placement-policy spillover/rejection counters
                policy = "".join(
                    f" {pol}[spill={c.get('spillover', 0)}"
                    f",rej={c.get('rejected', 0)}"
                    f",shed={c.get('shed', 0)}]"
                    for pol, c in sorted(pod.get("by_policy", {}).items()))
                # fabric routers carry liveness: live member count vs
                # fleet size, plus eviction/re-route totals
                fab = pod.get("fabric") or {}
                fabric = (f" live={fab.get('live', 0)}"
                          f"/{len(pod.get('pods', []))}"
                          f" evicted={fab.get('evictions', 0)}"
                          f" rerouted={fab.get('reroutes', 0)}"
                          if fab else "")
                print(f"{pod.get('router', p.stem):26s} "
                      f"policy={pod.get('policy', '?')} "
                      f"pods={len(pod.get('pods', []))}{fabric} "
                      f"capacity={pod.get('capacity', 0)} "
                      f"free={pod.get('free_slots', 0)} "
                      f"pending={pod.get('pending', 0)} "
                      f"rejected={pod.get('rejected', 0)} "
                      f"shed={pod.get('shed', 0)} "
                      f"spilled={pod.get('spilled', 0)}{policy} "
                      f"draining={draining} {phase:8s}")
                continue
            reps = pod.get("replicas", [])
            active = sum(r.get("active", 0) for r in reps)
            prefills = sum(r.get("prefill_execs", 0) for r in reps)
            router = pod.get("router")
            # prefix page cache (paged pods with --prefix-cache): hit/miss
            # + resident shared pages, summed over replicas
            pcs = [r["prefix_cache"] for r in reps if r.get("prefix_cache")]
            # radix registry: node/depth shape plus the spill tier's
            # traffic (pages currently in host RAM, spill/restore count)
            depth = max((c.get("max_depth", 0) for c in pcs), default=0)
            prefix = (f" phits={sum(c['hits'] for c in pcs)}"
                      f"/{sum(c['misses'] for c in pcs)}"
                      f" shared={sum(c['shared_pages'] for c in pcs)}"
                      f" radix={sum(c.get('nodes', 0) for c in pcs)}n"
                      f":{depth}d"
                      f" spilled={sum(c.get('spilled_pages', 0) for c in pcs)}"
                      f" sp/rs={sum(c.get('spills', 0) for c in pcs)}"
                      f"/{sum(c.get('restores', 0) for c in pcs)}"
                      if pcs else "")
            wasted = sum(r.get("tokens_wasted", 0) for r in reps)
            preempts = sum(r.get("preemptions", 0) for r in reps)
            qos = (f" preempt={preempts}" if preempts else "") + (
                f" shed={pod['shed']}" if pod.get("shed") else "")
            # p50/p99 from the registry snapshot riding the state file;
            # '-' when no request ever completed (0 would read as instant)
            p50, p99 = _snap_latency(pod.get("metrics", {}))
            print(f"{pod.get('pod', p.stem):26s} "
                  f"image={pod.get('image', '?')} "
                  f"replicas={len(reps)} capacity={pod.get('capacity', 0)} "
                  f"free={pod.get('free_slots', 0)} "
                  f"active={active} prefills={prefills} "
                  f"rejected={pod.get('rejected', 0)} wasted={wasted}{qos} "
                  f"p50/p99={p50}/{p99}{prefix} {phase:8s} "
                  f"ref={pod.get('ref') or '-'}"
                  + (f" router={router}" if router else ""))
    return 0


def cmd_run(rt: Runtime, args) -> int:
    from repro_torch.launch.train import main as train_main
    argv = ["--image", args.ref, "--root", str(rt.root),
            "--steps", str(args.steps), "--ckpt-every", str(args.ckpt_every),
            "--keep", str(args.keep)]
    if args.platform:
        argv += ["--platform", args.platform]
    if args.resume:
        argv += ["--resume"]
    train_main(argv)
    return 0


def cmd_serve(rt: Runtime, args) -> int:
    from repro_torch.launch.serve import main as serve_main
    argv = ["--image", args.ref, "--root", str(rt.root),
            "--mode", args.mode,
            "--replicas", str(args.replicas), "--slots", str(args.slots),
            "--pods", str(args.pods), "--policy", args.policy,
            "--requests", str(args.requests), "--gen", str(args.gen),
            "--prompt-len", str(args.prompt_len), "--seed", str(args.seed),
            "--fairness-cap", str(args.fairness_cap),
            "--arrive-per-tick", str(args.arrive_per_tick)]
    if args.platform:
        argv += ["--platform", args.platform]
    if args.paged:
        argv += ["--paged"]
    if args.paged or args.prefix_cache:
        # --prefix-cache implies --paged downstream; the page size must
        # ride along either way or it silently falls back to the default
        argv += ["--page-size", str(args.page_size)]
    if args.prefix_cache:
        argv += ["--prefix-cache"]
    if args.shared_prefix:
        argv += ["--shared-prefix", str(args.shared_prefix)]
    if args.spill_pages:
        argv += ["--spill-pages", str(args.spill_pages)]
    if args.batch_every:
        argv += ["--batch-every", str(args.batch_every)]
    if args.deadline_ticks is not None:
        argv += ["--deadline-ticks", str(args.deadline_ticks)]
    if args.shed_queue_depth is not None:
        argv += ["--shed-queue-depth", str(args.shed_queue_depth)]
    if args.shed_ttft_p99 is not None:
        argv += ["--shed-ttft-p99", str(args.shed_ttft_p99)]
    if args.trace:
        argv += ["--trace", args.trace]
    if args.fabric != "none":
        argv += ["--fabric", args.fabric,
                 "--min-pods", str(args.min_pods),
                 "--heartbeat-every", str(args.heartbeat_every),
                 "--miss-limit", str(args.miss_limit)]
        if args.max_pods is not None:
            argv += ["--max-pods", str(args.max_pods)]
        if args.scale_up_tokens is not None:
            argv += ["--scale-up-tokens", str(args.scale_up_tokens)]
        if args.scale_idle_ticks is not None:
            argv += ["--scale-idle-ticks", str(args.scale_idle_ticks)]
    serve_main(argv)
    return 0


def cmd_top(rt: Runtime, args) -> int:
    """Live fleet dashboard rendered from the metrics snapshots riding the
    pod/router state files -- nothing is re-derived from raw counters."""
    import time
    from repro_torch.orchestrator.obs.metrics import (snapshot_count,
                                                      snapshot_exemplar,
                                                      snapshot_percentile,
                                                      snapshot_total)

    def pct(snap, name, p, scale=1.0):
        v = snapshot_percentile(snap, name, p)
        if v is None:
            return "-"
        return f"{v * scale:g}"

    def render() -> int:
        pods_dir = rt.root / "pods"
        files = sorted(pods_dir.glob("*.json")) if pods_dir.exists() else []
        print(f"{'NAME':26s} {'PHASE':8s} {'LIVE':>5s} "
              f"{'QUEUE':>5s} {'POOL':>9s} "
              f"{'PREFIX':>7s} {'SP/RS':>7s} {'WASTED':>6s} "
              f"{'PREEMPT':>7s} {'SHED':>5s} "
              f"{'TOKENS':>7s} "
              f"{'P50/P99':>9s} {'TTFT':>9s} {'ITL':>11s} {'P99-RID':>7s}")
        shown = 0
        for p in files:
            try:
                pod = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if not isinstance(pod, dict) or "metrics" not in pod:
                continue
            is_router = pod.get("kind") == "router"
            name = pod.get("router" if is_router else "pod", p.stem)
            phase = pod.get("phase", "-")
            pid = pod.get("pid")
            if pid is not None and not _pid_alive(pid):
                phase = "exited"
            # fabric routers report member liveness (heartbeat view);
            # plain pods/routers have no probe, shown as '-'
            fab = pod.get("fabric") or {}
            live = (f"{fab.get('live', 0)}/{len(pod.get('pods', []))}"
                    if is_router and fab else "-")
            snap = pod["metrics"]
            queue = snapshot_total(snap, "queue_depth")
            in_use = snapshot_total(snap, "pool_in_use")
            pool_cap = sum(r.get("pool", {}).get("pages", 0)
                           for r in pod.get("replicas", []))
            pool = f"{in_use}/{pool_cap}" if pool_cap else "-"
            hits = snapshot_total(snap, "prefix_hits")
            misses = snapshot_total(snap, "prefix_misses")
            rate = (f"{hits / (hits + misses):.0%}" if hits + misses else "-")
            # spill-tier traffic: pages pushed to / pulled from host RAM
            spills = snapshot_total(snap, "pool_spills")
            restores = snapshot_total(snap, "pool_restores")
            sprs = f"{spills}/{restores}" if spills or restores else "-"
            lat = (f"{pct(snap, 'latency_ticks', 50)}"
                   f"/{pct(snap, 'latency_ticks', 99)}"
                   if snapshot_count(snap, "latency_ticks") else "-")
            ttft = (f"{pct(snap, 'ttft_ticks', 50)}"
                    f"/{pct(snap, 'ttft_ticks', 99)}"
                    if snapshot_count(snap, "ttft_ticks") else "-")
            # ITL is stored in milli-ticks; render in ticks/token
            itl = (f"{pct(snap, 'itl_milliticks', 50, 1e-3)}"
                   f"/{pct(snap, 'itl_milliticks', 99, 1e-3)}"
                   if snapshot_count(snap, "itl_milliticks") else "-")
            # the exemplar rid behind the latency p99: the concrete
            # request to pull out of the span trace when p99 spikes
            p99_rid = snapshot_exemplar(snap, "latency_ticks", 99)
            p99_rid = "-" if p99_rid is None else str(p99_rid)
            print(f"{name:26s} {phase:8s} {live:>5s} {queue:>5d} {pool:>9s} "
                  f"{rate:>7s} {sprs:>7s} "
                  f"{snapshot_total(snap, 'tokens_wasted'):>6d} "
                  f"{snapshot_total(snap, 'preemptions'):>7d} "
                  f"{snapshot_total(snap, 'requests_shed'):>5d} "
                  f"{snapshot_total(snap, 'tokens_out'):>7d} "
                  f"{lat:>9s} {ttft:>9s} {itl:>11s} {p99_rid:>7s}")
            shown += 1
        if not shown:
            print("(no pod state found -- run `serve` first)")
        return shown

    if not args.watch:
        render()
        return 0
    try:
        while True:
            print(f"\x1b[2J\x1b[Hrepro top  (every {args.watch:g}s, "
                  f"ctrl-c to exit)")
            render()
            time.sleep(args.watch)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_inspect(rt: Runtime, args) -> int:
    image = rt.pull(args.ref)
    print(json.dumps(image.config(), indent=2))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # `lint` must not construct a Runtime (it would create .stevedore)
    if argv[:1] == ["lint"]:
        raise NotImplementedError(_LINT)
    ap = argparse.ArgumentParser(prog="stevedore")
    ap.add_argument("--root", default=".stevedore")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("build", help="build an image from an Imagefile")
    p.add_argument("imagefile")
    p.add_argument("-t", "--tag", default=None)

    sub.add_parser("images", help="list images")

    p = sub.add_parser("history", help="show image layers")
    p.add_argument("ref")

    p = sub.add_parser("inspect", help="show merged image config")
    p.add_argument("ref")

    p = sub.add_parser("tag", help="tag an image")
    p.add_argument("ref")
    p.add_argument("tag")

    sub.add_parser("ps", help="list containers (overlays)")

    p = sub.add_parser("run", help="run training from an image")
    p.add_argument("ref")
    p.add_argument("--platform", default=None)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--keep", type=int, default=0,
                   help="checkpoints kept on disk (0: all)")

    p = sub.add_parser("serve",
                       help="serve a Pod of replicas (continuous batching)")
    p.add_argument("ref")
    p.add_argument("--platform", default=None)
    p.add_argument("--mode", choices=("continuous", "static"),
                   default="continuous")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--pods", type=int, default=1,
                   help="pods behind a PodRouter (>1 = multi-pod fleet)")
    p.add_argument("--policy",
                   choices=("shortest-queue", "consistent-hash",
                            "prefix-hash"),
                   default="shortest-queue",
                   help="router placement policy (--pods > 1)")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fairness-cap", type=int, default=8)
    p.add_argument("--arrive-per-tick", type=int, default=8)
    p.add_argument("--paged", action="store_true",
                   help="serve from a shared KV page pool (paged attention)")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--prefix-cache", action="store_true",
                   help="copy-on-write prefix page sharing (implies --paged)")
    p.add_argument("--spill-pages", type=int, default=0,
                   help="host-RAM spill tier for evicted prefix pages: "
                        "0 disables, -1 is unbounded, N caps the store "
                        "(needs --prefix-cache)")
    p.add_argument("--shared-prefix", type=int, default=0,
                   help="prepend an N-token shared system prompt to the "
                        "trace")
    p.add_argument("--batch-every", type=int, default=0,
                   help="tag every Nth request as batch QoS (sheddable + "
                        "preemptible); 0 = all interactive")
    p.add_argument("--deadline-ticks", type=int, default=None,
                   help="admission deadline (ticks) for batch requests")
    p.add_argument("--shed-queue-depth", type=int, default=None,
                   help="router overload threshold: shed batch traffic at "
                        "queue depth >= N")
    p.add_argument("--shed-ttft-p99", type=int, default=None,
                   help="router overload threshold: shed batch traffic at "
                        "ttft p99 >= N ticks")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="export request-lifecycle spans as Chrome "
                        "trace-event JSON (open in Perfetto)")
    p.add_argument("--fabric", choices=("none", "loopback", "proc"),
                   default="none",
                   help="serve over the cross-host fabric: framed message "
                        "transport in-process (loopback) or one OS "
                        "process per pod (proc)")
    p.add_argument("--min-pods", type=int, default=1,
                   help="elastic floor: heal back to N pods (--fabric)")
    p.add_argument("--max-pods", type=int, default=None,
                   help="elastic ceiling (--fabric); default --pods")
    p.add_argument("--heartbeat-every", type=int, default=4,
                   help="fabric liveness probe cadence in ticks")
    p.add_argument("--miss-limit", type=int, default=2,
                   help="consecutive missed probes before eviction")
    p.add_argument("--scale-up-tokens", type=int, default=None,
                   help="spawn a pod when outstanding tokens per live pod "
                        "exceed N (--fabric)")
    p.add_argument("--scale-idle-ticks", type=int, default=None,
                   help="drain+retire the newest pod after N idle ticks "
                        "(--fabric)")

    p = sub.add_parser("top",
                       help="live serving metrics (queue/pool/latency) "
                            "from the pod state files")
    p.add_argument("--watch", type=float, default=0, metavar="SECONDS",
                   help="refresh every N seconds until interrupted")

    p = sub.add_parser("lint", add_help=False,
                       help="static analysis of the stack's contracts "
                            "(not ported yet)")
    p.add_argument("lint_args", nargs=argparse.REMAINDER)

    args = ap.parse_args(argv)
    if args.cmd == "lint":        # reached via `--root X lint ...`
        raise NotImplementedError(_LINT)
    rt = Runtime(args.root)
    return {
        "build": cmd_build, "images": cmd_images, "history": cmd_history,
        "tag": cmd_tag, "ps": cmd_ps, "run": cmd_run, "serve": cmd_serve,
        "inspect": cmd_inspect, "top": cmd_top,
    }[args.cmd](rt, args)


if __name__ == "__main__":
    sys.exit(main())
