#!/usr/bin/env python3
"""What slows the compile daemon's z3 solves when worker threads share one
interpreter.

    PYTHONPATH=src python tools/daemon_z3_probe.py [--kernel sha2] [--size 20]

Needs z3 (``auto`` takes it where it is importable). Maps one suite kernel
on a SIZE x SIZE grid through ``repro_torch.api.Compiler`` (fast profile, z3
time backend, no cache) and prints one JSON line with the wall seconds of:

- ``alone``: the solve by itself;
- ``threads_py``: the solve in a thread beside 3 threads that run pure
  Python, at the interpreter's default switch interval (5 ms);
- ``threads_py_fast_switch``: the same at a switch interval of 0.05 ms;
- ``procs_py``: the solve beside 3 processes that run pure Python (the
  same load on the cores, no shared interpreter lock);
- ``pool_beside_threads_py``: the solve in a spawned worker process (as the
  compile daemon now runs a cold z3 solve) while 3 threads of this process
  run pure Python; the pool's start-up is paid before the clock starts;
- ``z3_api_calls``: the calls one solve makes into z3's C API wrappers
  (``z3core``); each makes two foreign calls through ctypes, the call and
  its error check, and ctypes gives up the interpreter lock around each.

If the daemon's slowdown is the interpreter lock, ``threads_py`` exceeds
``alone`` by about ``z3_api_calls`` times a few milliseconds (a thread that
gave the lock up waits up to one switch interval to take it back while the
others run Python), ``threads_py_fast_switch`` comes back near ``alone``,
and ``procs_py`` stays near ``alone``. Each entry is ``[seconds, mapped]``:
a solve that runs out of ``--budget-s`` is not mapped (the budget is
checked between solver calls, so building the encoding can overrun it).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.api import Compiler, resolve_options  # noqa: E402
from repro_torch.core.benchsuite import load_suite  # noqa: E402
from repro_torch.core.cgra import CGRA  # noqa: E402

SPINNERS = 3


def _spin(stop) -> None:
    """Pure Python until ``stop`` is set: holds the interpreter lock and
    gives it up only when asked at the switch interval."""
    while not stop.is_set():
        x = 0
        for i in range(2000):
            x += i * i


def _solve(args) -> list:
    """[wall seconds, mapped] of one z3 compile of the kernel."""
    comp = Compiler(CGRA(args.size, args.size),
                    resolve_options("fast", backend="z3", use_cache=False,
                                    time_budget_s=args.budget_s))
    dfg = load_suite([args.kernel])[args.kernel]
    t0 = time.perf_counter()
    res = comp.compile(dfg)
    wall = time.perf_counter() - t0
    if res.backend not in ("z3", ""):
        raise SystemExit(f"{args.kernel}: time backend {res.backend}, not z3")
    return [wall, res.ok]


def _in_pool(pool):
    """A solve function that runs the solve in ``pool``'s process."""
    return lambda args: pool.submit(_solve, args).result()


def _beside(args, make_worker, event, solve=_solve) -> list:
    workers = [make_worker(target=_spin, args=(event,), daemon=True)
               for _ in range(SPINNERS)]
    for w in workers:
        w.start()
    time.sleep(0.2)
    try:
        return solve(args)
    finally:
        event.set()
        for w in workers:
            w.join()


def _count_calls(args) -> int:
    calls = 0

    def prof(frame, event, _arg):
        nonlocal calls
        if event == "call" and frame.f_code.co_filename.endswith("z3core.py"):
            calls += 1

    sys.setprofile(prof)
    try:
        _solve(args)
    finally:
        sys.setprofile(None)
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="sha2")
    ap.add_argument("--size", type=int, default=20)
    ap.add_argument("--budget-s", type=float, default=60.0)
    args = ap.parse_args(argv)

    import z3  # noqa: F401  (fails here, not inside a thread, without z3)

    _solve(args)                                   # warm imports and caches
    out = {"kernel": args.kernel, "grid": f"{args.size}x{args.size}",
           "z3": z3.get_version_string(), "switch_interval_s": sys.getswitchinterval()}
    out["alone"] = _solve(args)
    out["threads_py"] = _beside(args, threading.Thread, threading.Event())
    default = sys.getswitchinterval()
    sys.setswitchinterval(5e-5)
    try:
        out["threads_py_fast_switch"] = _beside(args, threading.Thread, threading.Event())
    finally:
        sys.setswitchinterval(default)
    ctx = mp.get_context("spawn")
    out["procs_py"] = _beside(args, ctx.Process, ctx.Event())
    with ProcessPoolExecutor(1, mp_context=ctx) as pool:
        pool.submit(_solve, args).result()         # start-up and imports
        out["pool_beside_threads_py"] = _beside(
            args, threading.Thread, threading.Event(), _in_pool(pool))
    out["z3_api_calls"] = _count_calls(args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
