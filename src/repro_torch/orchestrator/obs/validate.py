"""Trace validation CLI: ``python -m repro_torch.orchestrator.obs.validate``.

Two modes, both CI gates:

* ``validate t.json`` -- the Chrome trace-event schema check
  (``validate_chrome_trace``): every event has ``ph``/``ts``/``pid``/
  ``name``, durations are non-negative, timestamps monotone per request.
  A ``serve --trace`` run is gated on this exiting 0.
* ``validate --spans <runtime-root> [--fleet NAME]`` -- the cross-host
  half: rehydrate every per-process span file a fabric fleet wrote under
  ``<root>/spans/``, replay each against the span state machine
  (``validate_span_log``), then prove fleet-wide lifecycle closure
  (``validate_fleet_closure``): every routed rid reached a terminal span
  SOMEWHERE, even when route/reroute and submit..complete live in
  different processes' files.

PyTorch port of ``repro.orchestrator.obs.validate``, line for line.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.orchestrator.obs.tracing import (validate_chrome_trace,
                                                  validate_fleet_closure,
                                                  validate_span_log)


def _validate_spans(root: str, fleet: str | None) -> int:
    from repro_torch.orchestrator.fabric import load_fleet_spans
    buffers = load_fleet_spans(root, fleet=fleet)
    scope = f"fleet {fleet!r}" if fleet else "all fleets"
    if not buffers:
        print(f"INVALID {root}: no span files for {scope} under "
              f"{root}/spans/", file=sys.stderr)
        return 1
    try:
        log = validate_span_log(buffers)
        closure = validate_fleet_closure(buffers)
    except ValueError as e:
        print(f"INVALID {root} ({scope}): {e}", file=sys.stderr)
        return 1
    print(f"OK {root} ({scope}): {log['buffers']} span file(s), "
          f"{log['events']} events; closure {closure['routed']} routed "
          f"/ {closure['closed']} closed / {closure['rerouted']} "
          "rerouted")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.orchestrator.obs.validate",
        description="validate a Chrome trace-event JSON exported by "
                    "`serve --trace`, or (--spans) a fabric fleet's "
                    "per-process span files")
    ap.add_argument("target",
                    help="trace JSON file; with --spans, the runtime "
                         "root the fleet served from")
    ap.add_argument("--spans", action="store_true",
                    help="validate per-process span files under "
                         "<target>/spans/ and the fleet-wide lifecycle "
                         "closure instead of a Chrome trace")
    ap.add_argument("--fleet", default=None,
                    help="with --spans: narrow to one fleet's files "
                         "(worker files are <fleet>-<ordinal>, the "
                         "router's <fleet>-router)")
    args = ap.parse_args(argv)
    if args.spans:
        return _validate_spans(args.target, args.fleet)
    try:
        stats = validate_chrome_trace(args.target)
    except (OSError, ValueError) as e:
        print(f"INVALID {args.target}: {e}", file=sys.stderr)
        return 1
    print(f"OK {args.target}: {stats['events']} events, "
          f"{stats['requests']} requests")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
