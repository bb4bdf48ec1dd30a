"""Render the roofline table + dry-run summary from results/dryrun artifacts
(the port of ``repro.launch.report``, a copy: the port's records have the
JAX package's keys, so one table renders either package's artifacts).

  PYTHONPATH=src python -m repro_torch.launch.report --dir results/dryrun [--md]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def load(dir_: str) -> list[dict]:
    recs = []
    for p in sorted(Path(dir_).glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def fmt_s(x: float) -> str:
    return f"{x:.2e}"


def table(recs: list[dict], md: bool = False, mesh: str | None = None) -> str:
    rows = []
    hdr = ["arch", "shape", "mesh", "kind", "compute_s", "memory_s",
           "collective_s", "dominant", "GiB/dev", "fits", "useful", "roofline"]
    for r in recs:
        if r.get("status") == "skipped":
            if mesh is None or r["mesh"] == mesh:
                rows.append([r["arch"], r["shape"], r["mesh"], "--",
                             "--", "--", "--", "SKIPPED", "--", "--", "--",
                             "--"])
            continue
        if r.get("status") != "ok":
            rows.append([r["arch"], r["shape"], r["mesh"], "--"] +
                        ["FAILED"] * 8)
            continue
        if mesh is not None and r["mesh"] != mesh:
            continue
        rl = r["roofline"]
        mem = r["memory"]
        rows.append([
            r["arch"], r["shape"], r["mesh"], r["kind"],
            fmt_s(rl["compute_s"]), fmt_s(rl["memory_s"]),
            fmt_s(rl["collective_s"]), rl["dominant"],
            f"{mem['resident_bytes_per_device'] / 2**30:.2f}",
            "y" if mem["fits_hbm"] else "N",
            f"{rl['useful_flops_fraction']:.3f}",
            f"{rl['roofline_fraction']:.4f}",
        ])
    widths = [max(len(str(row[i])) for row in rows + [hdr])
              for i in range(len(hdr))]
    sep = " | " if md else "  "
    out = [sep.join(h.ljust(w) for h, w in zip(hdr, widths))]
    if md:
        out[0] = "| " + out[0] + " |"
        out.append("|" + "|".join("-" * (w + 2) for w in widths) + "|")
        for row in rows:
            out.append("| " + sep.join(str(c).ljust(w)
                                       for c, w in zip(row, widths)) + " |")
    else:
        out.append("-" * len(out[0]))
        for row in rows:
            out.append(sep.join(str(c).ljust(w) for c, w in zip(row, widths)))
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print(table(recs, md=args.md, mesh=args.mesh))
    ok = [r for r in recs if r.get("status") == "ok"]
    if ok:
        worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
        coll = max(ok, key=lambda r: r["roofline"]["collective_s"]
                   / max(r["roofline"]["bound_s"]
                         if "bound_s" in r["roofline"] else
                         max(r["roofline"]["compute_s"],
                             r["roofline"]["memory_s"],
                             r["roofline"]["collective_s"]), 1e-30))
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']}/"
              f"{worst['mesh']} = {worst['roofline']['roofline_fraction']:.4f}")
        print(f"most collective-bound:   {coll['arch']}/{coll['shape']}/"
              f"{coll['mesh']} collective_s={coll['roofline']['collective_s']:.2e}")


if __name__ == "__main__":
    main()
