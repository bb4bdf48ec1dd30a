"""Trace validation CLI: ``python -m repro_torch.orchestrator.obs.validate``.

* ``validate t.json`` -- the Chrome trace-event schema check
  (``validate_chrome_trace``): every event has ``ph``/``ts``/``pid``/
  ``name``, durations are non-negative, timestamps monotone per request.
  A ``serve --trace`` run is gated on this exiting 0.
* ``validate --spans <runtime-root> [--fleet NAME]`` -- the cross-host
  half, over the per-process span files a fabric fleet writes. The fabric
  is not ported yet (ROADMAP.md Queue 1 item 8), so this mode raises.

PyTorch port of ``repro.orchestrator.obs.validate`` (the Chrome-trace
half, line for line).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.orchestrator.obs.tracing import validate_chrome_trace

_FABRIC = ("the cross-host fabric (fabric.py, fabric_worker.py) is not "
           "ported yet (ROADMAP.md Queue 1 item 8: fleet); --spans reads "
           "the span files its workers write")


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
                    help="with --spans: narrow to one fleet's files")
    args = ap.parse_args(argv)
    if args.spans:
        raise NotImplementedError(_FABRIC)
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
