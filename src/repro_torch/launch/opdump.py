"""Per-op byte/flop breakdown of one unit probe -- the dry-run 'profiler'
(the port of ``repro.launch.opdump``).

  PYTHONPATH=src python -m repro_torch.launch.opdump --arch deepseek-67b \\
      --shape train_4k --mesh multipod --stage 0 [--settings '{...}']

Groups the bytes (each aten operator's inputs read plus outputs written)
and FLOPs of one unit of stage ``--stage``, traced on rank 0 of the
mesh's fake job (``Container.lower_unit_probe``), by aten operator -- a
kernel wrapper's own ``cost()`` under ``kernel:<name>`` -- and its
collectives by operation, with the largest ones: where the roofline's
memory and collective terms come from.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.container import Container
from repro_torch.launch.dryrun import MESH_PLATFORMS, build_image
from repro_torch.launch.mesh import fake_platform_mesh


def op_breakdown(counter) -> dict[str, float]:
    """Bytes by operator of a traced ``core.trace.Counter``."""
    return {op: row[1] for op, row in counter.by_op.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument("--collectives", default="generic")
    ap.add_argument("--settings", default='{"remat":"dots"}')
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    image = build_image(args.arch, args.shape, args.mesh,
                        collectives=args.collectives,
                        settings=json.loads(args.settings))
    with fake_platform_mesh(MESH_PLATFORMS[args.mesh]) as mesh:
        c = Container(image, platform=args.mesh, mesh=mesh, device="meta")
        lowered, count = c.lower_unit_probe(args.stage, c.cell.kind)
    cost = lowered.cost()
    print(f"# unit probe {args.arch}/{args.shape}/{args.mesh} "
          f"stage{args.stage} x{count}")
    print(f"# flops/dev={cost.flops:.3e}  "
          f"bytes_accessed/dev={cost.bytes_accessed:.3e}")
    st = cost.collectives
    print("# collectives (per unit, per device):")
    for op in sorted(st.bytes_by_op, key=lambda o: -st.bytes_by_op[o]):
        print(f"#   {op:20s} n={st.count_by_op[op]:4d} "
              f"bytes={st.bytes_by_op[op]:.3e}")
    for b, op in sorted(lowered.counter.collective_calls, reverse=True)[:8]:
        print(f"#   big: {op:22s} {b:.3e}")
    agg = op_breakdown(lowered.counter)
    total = sum(agg.values())
    print(f"# bytes total (per unit, per device): {total:.3e}")
    for op, b in sorted(agg.items(), key=lambda kv: -kv[1])[: args.top]:
        flops = lowered.counter.by_op[op][0]
        print(f"{op:28s} {b:.3e}  {b / total * 100 if total else 0:5.1f}%"
              f"  flops {flops:.3e}")


if __name__ == "__main__":
    main()
