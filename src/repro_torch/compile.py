"""``python -m repro_torch.compile`` — batch-compile DFGs and emit a JSON report.

The CLI front-end of the :mod:`repro_torch.api` compiler layer (DESIGN.md §11): it
gathers a workload (the built-in Table III suite and/or a directory of
``DFG.to_json`` files), resolves its flags through the single
``resolve_options`` path shared by every frontend, and maps the workload
through a :class:`repro_torch.api.Compiler` session. The JSON report embeds the
resolved options block and one unified ``CompileResult`` row per job.

Examples::

    # the 17-benchmark suite on a 5x5 CGRA, 4 workers, persistent cache
    PYTHONPATH=src python -m repro_torch.compile --suite --size 5 --jobs 4 \\
        --cache-dir ~/.cache/repro-maps --report report.json

    # a directory of extracted DFG JSON files, reproducible CI profile
    PYTHONPATH=src python -m repro_torch.compile --dfg-dir kernels/ --size 8 \\
        --profile deterministic-ci

    # a heterogeneous target: named preset or ArchSpec JSON (core/arch)
    PYTHONPATH=src python -m repro_torch.compile --suite \\
        --arch satmapit_edge_mem_4x4 --jobs 4

A second run against the same ``--cache-dir`` serves every job from the
persistent cache (``"solved": 0`` in the report's cache counters) — warm
restarts of a compile server never re-solve.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch import obs
from repro_torch.api import Compiler, add_cli_args, options_from_args
from repro_torch.core.cgra import CGRA
from repro_torch.core.dfg import DFG


def _load_dfg_dir(path: str) -> list[DFG]:
    dfgs = []
    for fn in sorted(os.listdir(path)):
        if not fn.endswith(".json"):
            continue
        full = os.path.join(path, fn)
        try:
            with open(full, "r", encoding="utf-8") as f:
                dfg = DFG.from_json(f.read())
            dfg.validate()
        except (OSError, ValueError, KeyError) as exc:
            print(f"skipping {full}: {exc}", file=sys.stderr)
            continue
        if dfg.name == "dfg":
            dfg.name = os.path.splitext(fn)[0]
        dfgs.append(dfg)
    return dfgs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compile",
        description="Batch-compile DFGs onto a CGRA and emit a JSON report.",
    )
    src = ap.add_argument_group("workload")
    src.add_argument("--suite", action="store_true",
                     help="compile the built-in 17-benchmark Table III suite")
    src.add_argument("--bench", action="append", default=[],
                     help="one suite benchmark by name (repeatable)")
    src.add_argument("--dfg-dir", metavar="DIR",
                     help="directory of DFG.to_json files (*.json)")
    tgt = ap.add_argument_group("target CGRA")
    tgt.add_argument("--size", type=int, default=5,
                     help="square grid size N (NxN, default 5)")
    tgt.add_argument("--rows", type=int, help="grid rows (overrides --size)")
    tgt.add_argument("--cols", type=int, help="grid cols (overrides --size)")
    tgt.add_argument("--topology",
                     choices=["mesh", "torus", "diagonal", "one-hop"],
                     default="mesh")
    # the shared compiler-option flags (--profile, --jobs, --cache-dir,
    # --deterministic, --arch, ...) — defined ONCE in repro_torch.api.options
    add_cli_args(ap)
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="write the JSON report here (default: stdout summary only)")
    ap.add_argument("--report-utilization", action="store_true",
                    help="attach a fabric-utilization block (per-PE occupancy, "
                         "route wire hops) to every successful row")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        opts = options_from_args(args)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 2
    if opts.deadline_s is None and not opts.deterministic:
        # this CLI's historical per-job wall budget; --deadline-s overrides
        opts = opts.replace(deadline_s=60.0)

    dfgs: list[DFG] = []
    if args.suite or args.bench:
        from repro_torch.core.benchsuite import load_suite

        # --suite always means the full 17 (it subsumes any --bench names)
        suite = load_suite(names=None if args.suite else args.bench)
        dfgs.extend(suite.values())
    if args.dfg_dir:
        dfgs.extend(_load_dfg_dir(args.dfg_dir))
    if not dfgs:
        print("no DFGs to compile: pass --suite, --bench, or --dfg-dir",
              file=sys.stderr)
        return 2

    if opts.arch:
        try:
            compiler = Compiler(options=opts)
        except ValueError as exc:
            print(str(exc), file=sys.stderr)
            return 2
    else:
        rows = args.rows if args.rows is not None else args.size
        cols = args.cols if args.cols is not None else args.size
        compiler = Compiler(CGRA(rows, cols, topology=args.topology), opts)

    problems = compiler.validate_workload(dfgs)
    if problems:
        target = compiler.spec.name if compiler.spec else str(compiler.cgra)
        for p in problems:
            print(f"workload incompatible with {target}: {p}", file=sys.stderr)
        return 2

    # structured tracing (DESIGN.md §15): --trace records the whole batch
    # under one tracer and writes a Perfetto-loadable Chrome trace JSON
    with obs.session(getattr(args, "trace_out", None), enable=opts.trace):
        batch = compiler.compile_batch(dfgs)
    if getattr(args, "trace_out", None) and not args.quiet:
        print(f"wrote trace {os.path.abspath(args.trace_out)}")

    if args.report_utilization:
        from repro_torch.core.simulate import utilization_report

        for r in batch:
            if r.ok and r.mapping is not None:
                r.utilization = utilization_report(r.mapping)

    if not args.quiet:
        for r in batch:
            status = f"II={r.ii}" if r.ok else f"FAILED ({r.reason})"
            print(f"{r.name:20s} {status:24s} {r.wall_s:7.3f}s  [{r.source or r.failure}]")
            if r.utilization is not None:
                u = r.utilization
                print(f"{'':20s}   util: {u['pes_used']}/{u['num_pes']} PEs, "
                      f"{u['slots_used']}/{u['slots_total']} slots "
                      f"({100 * u['occupancy']:.1f}%), "
                      f"{u['route_wire_hops']} route wire hops")
        c = batch.cache_counters
        print(f"--- {len(batch)} jobs on {compiler.cgra} in {batch.wall_s:.2f}s "
              f"({batch.num_workers} workers): {c['solved']} solved, "
              f"{c['memory_hits']} memory hits, {c['disk_hits']} disk hits, "
              f"{c['failed']} failed")

    if args.report:
        spec = compiler.spec
        payload = {
            "cgra": {"rows": compiler.cgra.rows, "cols": compiler.cgra.cols,
                     "topology": compiler.cgra.topology},
            "arch": (None if spec is None
                     else {"name": spec.name, "spec_hash": spec.spec_hash()}),
            "deterministic": opts.deterministic,
            "options": opts.as_dict(),
            **batch.as_dict(),
        }
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
        if not args.quiet:
            print(f"wrote {os.path.abspath(args.report)}")
    return 0 if batch.ok else 1


if __name__ == "__main__":
    sys.exit(main())
