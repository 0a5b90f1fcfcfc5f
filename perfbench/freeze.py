#!/usr/bin/env python3
"""Write the benchmark's frozen inputs; run once, on the CPU.

    PYTHONPATH=src python3 perfbench/freeze.py [--config NAME ...] [--jobs 4]

* ``data/dfgs/<kernel>.json``: the 17 Table III DFGs of the port's
  ``core/benchsuite.py``, as ``DFG.to_json`` writes them. A later change to
  the generator cannot move the yardstick; ``tests/test_perfbench_frozen.py``
  says whether they still agree.
* ``data/mappings/<config>/<kernel>.json``: one mapping of each kernel on
  each configuration's fabric, for the exec cells, made by the port's mapper
  through ``compile_many`` with the configuration's options, the time backend
  replaced by ``--backend`` (default ``auto``: z3 where it is importable, cp
  elsewhere). Each is held to the benchmark's own legality checker before it
  is written.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import legality, suite  # noqa: E402
from perfbench.reference import PlainDFG  # noqa: E402


def dfg_texts() -> dict[str, str]:
    """The port's Table III DFGs today, as their frozen files would hold them."""
    from repro_torch.core.benchsuite import load_suite

    return {name: dfg.to_json() + "\n" for name, dfg in load_suite().items()}


def write_dfgs() -> None:
    out = suite.DATA / "dfgs"
    out.mkdir(parents=True, exist_ok=True)
    for name, text in dfg_texts().items():
        (out / f"{name}.json").write_text(text)
    print(f"wrote {len(dfg_texts())} DFGs to {out}")


def write_mappings(config_name: str, *, jobs: int, backend: str) -> None:
    from repro_torch.core.service import CompileJob, compile_many

    config = suite.load_config(config_name)
    dfgs = suite.port_dfgs(config)
    cgra = suite.port_cgra(config)
    mesh = suite.mesh(config)
    opts = suite.compile_options(config).replace(backend=backend)
    report = compile_many([CompileJob(d, cgra, name=k) for k, d in dfgs.items()],
                          jobs=jobs, use_cache=False, map_options=opts)
    out = suite.DATA / "mappings" / config_name
    out.mkdir(parents=True, exist_ok=True)
    for job in report.jobs:
        if not job.ok or job.routes:
            raise SystemExit(f"{config_name}/{job.name}: not mapped directly ({job.reason})")
        plain = PlainDFG.load(suite.dfg_path(job.name))
        errs = legality.violations(plain, mesh, job.ii, job.t_abs, job.placement)
        if errs:
            raise SystemExit(f"{config_name}/{job.name}: illegal mapping: {errs[:3]}")
        row = dict(config=config_name, kernel=job.name, ii=job.ii,
                   mii=legality.min_ii(plain, mesh), backend=job.backend,
                   space_backend=job.space_backend, profile=opts.profile,
                   t_abs=job.t_abs, placement=job.placement)
        (out / f"{job.name}.json").write_text(json.dumps(row) + "\n")
        print(f"  {config_name}/{job.name}: II {job.ii} (mII {row['mii']}), "
              f"{job.backend}/{job.space_backend}, {job.wall_s:.2f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", action="append", default=None,
                    help="configuration to map (default: every file in configs/)")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--backend", default="auto", help="time backend of the mapper")
    ap.add_argument("--skip-dfgs", action="store_true")
    args = ap.parse_args()
    if not args.skip_dfgs:
        write_dfgs()
    names = args.config or sorted(p.stem for p in (suite.HERE / "configs").glob("*.json"))
    for name in names:
        write_mappings(name, jobs=args.jobs, backend=args.backend)


if __name__ == "__main__":
    main()
