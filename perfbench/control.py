#!/usr/bin/env python3
"""The control of the check: the plain reference, in bfloat16, put in the
program's place, at a cell's own size. It has to come out not correct.

    python3 perfbench/control.py --workload <cell> --seed <n> [--seed <m> ...]

For each seed it draws the streams that a run with that seed feeds the
kernels the check compares (a compile cell: every kernel of its first pass;
an exec cell: ``checked_per_kernel`` batches of each kernel), computes the
stores in bfloat16 and prints ``store_mismatches`` against the float32
reference, the number the check compares with the limit 0. The benchmark's
own runs never run it. Needs no card and no part of the port.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    HERE = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(HERE.parent))

from perfbench import executor, reference, suite  # noqa: E402
from perfbench.harness import benchmark, cell_entry  # noqa: E402
from perfbench.inputs import StreamPool  # noqa: E402


def control_reading(cell_name: str, seed: int) -> dict:
    cell = suite.load_cell(cell_name)
    config = suite.load_config(cell_entry(benchmark(), cell_name)["config"])
    traffic = cell["traffic"]
    iters, streams = traffic["iterations"], traffic["streams"]
    pool = StreamPool(seed, iters, streams)
    plain = suite.plain_dfgs(config)
    keys = []
    for index, (k, dfg) in enumerate(plain.items()):
        if cell["kind"] == "compile":
            keys.append((k, ("pass", 0, k)))
        else:
            n = len(plain)
            keys += [(k, ("batch", index + j * n)) for j in range(traffic["checked_per_kernel"])]
    mismatched = 0
    for k, key in keys:
        s = pool.streams(plain[k].inputs(), *key)
        low = reference.interpret(plain[k], s, iters, precision="bfloat16")
        mismatched += executor.store_mismatches(plain[k], s, low, iters)
    return {"cell": cell_name, "seed": seed, "batches": len(keys),
            "store_mismatches": mismatched}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args()
    for seed in args.seed:
        t0 = time.perf_counter()
        row = control_reading(args.workload, seed)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
