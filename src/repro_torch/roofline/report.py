"""Render the dry-run sweep (results/dryrun/*.json) into the roofline tables.

A copy of the JAX package's ``src/repro/roofline/report.py``; it renders
both packages' result files (``launch/dryrun.py`` writes the same keys).

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun
"""

from __future__ import annotations

import json
import os
import sys


def load_results(results_dir: str) -> list[dict]:
    out = []
    for f in sorted(os.listdir(results_dir)):
        if f.endswith(".json"):
            with open(os.path.join(results_dir, f)) as fh:
                out.append(json.load(fh))
    return out


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _gb(x: float) -> str:
    return f"{x/2**30:.2f}"


def roofline_table(rows: list[dict], mesh: str) -> str:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck "
        "| useful/HLO | MFU bound | args GB/dev | temps GB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if not r.get("ok") or r["mesh"] != mesh:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['t_compute'])} "
            f"| {_fmt_s(r['t_memory'])} | {_fmt_s(r['t_collective'])} "
            f"| **{r['bottleneck']}** | {r['useful_flops_ratio']*100:.0f}% "
            f"| {r['mfu_upper_bound']*100:.2f}% | {_gb(r['arg_bytes_per_dev'])} "
            f"| {_gb(r['temp_bytes_per_dev'])} |"
        )
    return "\n".join(lines)


def collective_detail(rows: list[dict], mesh: str) -> str:
    lines = [
        "| arch | shape | AR GB | AG GB | RS GB | A2A GB | permute GB |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if not r.get("ok") or r["mesh"] != mesh:
            continue
        c = r.get("collectives", {})
        g = lambda k: f"{c.get(k, 0)/2**30:.2f}"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {g('all-reduce')} | {g('all-gather')} "
            f"| {g('reduce-scatter')} | {g('all-to-all')} | {g('collective-permute')} |"
        )
    return "\n".join(lines)


def summary(rows: list[dict]) -> str:
    ok = [r for r in rows if r.get("ok")]
    fail = [r for r in rows if not r.get("ok")]
    per_b = {}
    for r in ok:
        per_b[r["bottleneck"]] = per_b.get(r["bottleneck"], 0) + 1
    worst = sorted(ok, key=lambda r: r["mfu_upper_bound"])[:3]
    coll = sorted(ok, key=lambda r: -r["t_collective"])[:3]
    lines = [
        f"- cells compiled OK: {len(ok)}; failed: {len(fail)}",
        f"- bottleneck distribution: {per_b}",
        "- lowest MFU-upper-bound cells: "
        + ", ".join(f"{r['arch']}/{r['shape']}/{r['mesh']} ({r['mfu_upper_bound']*100:.2f}%)" for r in worst),
        "- most collective-bound cells: "
        + ", ".join(f"{r['arch']}/{r['shape']}/{r['mesh']} ({_fmt_s(r['t_collective'])})" for r in coll),
    ]
    return "\n".join(lines)


def main() -> None:
    results_dir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    rows = load_results(results_dir)
    print("## Summary\n")
    print(summary(rows))
    for mesh in ("16x16", "2x16x16"):
        print(f"\n## Roofline — {mesh} mesh\n")
        print(roofline_table(rows, mesh))
        print(f"\n### Collective detail — {mesh}\n")
        print(collective_detail(rows, mesh))


if __name__ == "__main__":
    main()
