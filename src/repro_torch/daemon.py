"""``python -m repro_torch.daemon`` — the persistent compile-daemon CLI.

Front-end of :mod:`repro_torch.core.daemon` (DESIGN.md §16): ``serve`` runs a
:class:`~repro_torch.core.daemon.CompileDaemon` behind a unix socket; ``submit``,
``stats``, ``ping`` and ``shutdown`` talk to a running daemon over the
NDJSON protocol.

Examples::

    # serve the 5x5 mesh with 4 workers and a persistent cache
    PYTHONPATH=src python -m repro_torch.daemon serve --socket /tmp/repro_torch.sock \\
        --size 5 --workers 4 --cache-dir ~/.cache/repro-maps &

    # compile suite kernels through it (full CompileResult rows, NDJSON)
    PYTHONPATH=src python -m repro_torch.daemon submit --socket /tmp/repro_torch.sock \\
        --bench fft --bench bitcount --tenant ci --request-deadline-s 10

    # observe, then stop
    PYTHONPATH=src python -m repro_torch.daemon stats --socket /tmp/repro_torch.sock
    PYTHONPATH=src python -m repro_torch.daemon shutdown --socket /tmp/repro_torch.sock

``serve`` accepts the shared compiler-option flags (``--profile``,
``--cache-dir``, ...) plus daemon knobs: ``--workers``, ``--queue-limit``,
``--no-speculate``, ``--cache-max-bytes`` / ``--cache-max-age-s`` (periodic
disk-cache pruning), and ``--trace-dir`` (rotated per-segment span files
that ``tools/trace_report.py`` reads directly).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from repro_torch.api import add_cli_args, options_from_args
from repro_torch.core.cgra import CGRA
from repro_torch.core.daemon import CompileDaemon, DaemonClient, DaemonError, DaemonServer
from repro_torch.core.dfg import DFG

DEFAULT_SOCKET = "/tmp/repro_torch-daemon.sock"


def _add_socket_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--socket", default=DEFAULT_SOCKET,
                    help=f"daemon unix-socket path (default {DEFAULT_SOCKET})")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.daemon",
        description="Persistent CGRA compile daemon (serve) and its client "
                    "verbs (submit / stats / ping / shutdown).",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    serve = sub.add_parser("serve", help="run the compile daemon")
    _add_socket_arg(serve)
    tgt = serve.add_argument_group("target CGRA")
    tgt.add_argument("--size", type=int, default=5,
                     help="square grid size N (NxN, default 5)")
    tgt.add_argument("--rows", type=int, help="grid rows (overrides --size)")
    tgt.add_argument("--cols", type=int, help="grid cols (overrides --size)")
    tgt.add_argument("--topology",
                     choices=["mesh", "torus", "diagonal", "one-hop"],
                     default="mesh")
    add_cli_args(serve)  # the shared compiler-option flags, defined once
    dmn = serve.add_argument_group("daemon")
    dmn.add_argument("--workers", type=int, default=2,
                     help="compile worker threads (default 2)")
    dmn.add_argument("--queue-limit", type=int, default=64, dest="queue_limit",
                     help="max queued requests before admission control "
                          "sheds with the 'overloaded' failure code")
    dmn.add_argument("--no-speculate", action="store_false", default=True,
                     dest="speculate",
                     help="disable idle-time speculative premapping of "
                          "neighboring option variants")
    dmn.add_argument("--cache-max-bytes", type=int, default=None,
                     dest="cache_max_bytes",
                     help="prune the disk mapping cache LRU-by-mtime to this "
                          "byte budget during idle maintenance")
    dmn.add_argument("--cache-max-age-s", type=float, default=None,
                     dest="cache_max_age_s",
                     help="evict disk-cache entries older than this many "
                          "seconds during idle maintenance")
    dmn.add_argument("--trace-dir", default=None, dest="trace_dir",
                     help="rotate per-request span segments into this "
                          "directory as Chrome trace-event JSON files "
                          "(tools/trace_report.py reads each segment)")
    dmn.add_argument("--rotate-every", type=int, default=256,
                     dest="rotate_every",
                     help="completed requests per rotated trace segment")
    dmn.add_argument("--quiet", action="store_true")

    submit = sub.add_parser(
        "submit", help="compile DFGs through a running daemon")
    _add_socket_arg(submit)
    submit.add_argument("--bench", action="append", default=[],
                        help="a built-in suite benchmark by name (repeatable)")
    submit.add_argument("--dfg", action="append", default=[], metavar="FILE",
                        help="a DFG.to_json file (repeatable)")
    submit.add_argument("--tenant", default=None,
                        help="tenant label attached to each request")
    submit.add_argument("--request-deadline-s", type=float, default=None,
                        dest="request_deadline_s",
                        help="per-request deadline (expired requests come "
                             "back 'cancelled', shed ones 'overloaded')")
    submit.add_argument("--options", default=None, metavar="JSON",
                        help="per-request CompileOptions overrides as a JSON "
                             'object, e.g. \'{"max_route_hops": 1}\'')
    submit.add_argument("--quiet", action="store_true",
                        help="suppress the per-row summary lines (NDJSON "
                             "rows still go to stdout)")

    for verb, txt in (("stats", "print daemon counters as JSON"),
                      ("ping", "liveness probe (exit 0 = alive)"),
                      ("shutdown", "stop a running daemon")):
        p = sub.add_parser(verb, help=txt)
        _add_socket_arg(p)
    return ap


def _cmd_serve(args: argparse.Namespace) -> int:
    try:
        opts = options_from_args(args)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 2
    if opts.arch:
        target = None  # Compiler resolves options.arch
    else:
        rows = args.rows if args.rows is not None else args.size
        cols = args.cols if args.cols is not None else args.size
        target = CGRA(rows, cols, topology=args.topology)
    daemon = CompileDaemon(
        target, opts,
        workers=args.workers,
        queue_limit=args.queue_limit,
        speculate=args.speculate,
        cache_max_bytes=args.cache_max_bytes,
        cache_max_age_s=args.cache_max_age_s,
        trace_dir=args.trace_dir,
        rotate_every=args.rotate_every,
    )
    server = DaemonServer(daemon, args.socket)
    try:
        server.start()
    except (OSError, RuntimeError) as exc:
        print(f"cannot serve on {args.socket}: {exc}", file=sys.stderr)
        return 2
    # SIGTERM/SIGINT take the same graceful path as the shutdown op, so a
    # supervised daemon (or ^C) still drains, rotates traces, and unlinks
    # the socket
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(
            sig, lambda *_: server._shutdown_requested.set())
    if not args.quiet:
        print(f"repro_torch daemon serving on {args.socket} "
              f"({daemon.num_workers} workers, queue limit "
              f"{daemon.queue_limit}, speculate={daemon.speculate})",
              flush=True)
    server.serve_forever()
    if not args.quiet:
        print("repro_torch daemon stopped", flush=True)
    return 0


def _load_submit_dfgs(args: argparse.Namespace) -> list[DFG]:
    dfgs: list[DFG] = []
    if args.bench:
        from repro_torch.core.benchsuite import load_suite

        dfgs.extend(load_suite(names=args.bench).values())
    for path in args.dfg:
        with open(path, "r", encoding="utf-8") as f:
            dfg = DFG.from_json(f.read())
        dfg.validate()
        if dfg.name == "dfg":
            dfg.name = os.path.splitext(os.path.basename(path))[0]
        dfgs.append(dfg)
    return dfgs


def _cmd_submit(args: argparse.Namespace) -> int:
    overrides = None
    if args.options:
        try:
            overrides = json.loads(args.options)
            if not isinstance(overrides, dict):
                raise ValueError("not a JSON object")
        except ValueError as exc:
            print(f"bad --options JSON: {exc}", file=sys.stderr)
            return 2
    try:
        dfgs = _load_submit_dfgs(args)
    except (OSError, ValueError, KeyError) as exc:
        print(f"cannot load DFGs: {exc}", file=sys.stderr)
        return 2
    if not dfgs:
        print("nothing to submit: pass --bench and/or --dfg", file=sys.stderr)
        return 2
    ok = True
    with DaemonClient(args.socket) as client:
        for dfg in dfgs:
            row = client.compile(
                dfg, tenant=args.tenant,
                deadline_s=args.request_deadline_s, options=overrides)
            ok = ok and row["ok"]
            print(json.dumps(row))
            if not args.quiet:
                status = (f"II={row['ii']}" if row["ok"]
                          else f"FAILED ({row['failure']})")
                print(f"# {row['name']:20s} {status:24s} "
                      f"{row['wall_s']:7.3f}s  [{row['source'] or '-'}] "
                      f"queue {row['service']['queue_s'] * 1e3:.1f}ms",
                      file=sys.stderr)
    return 0 if ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "serve":
        return _cmd_serve(args)
    try:
        if args.cmd == "submit":
            return _cmd_submit(args)
        with DaemonClient(args.socket) as client:
            if args.cmd == "ping":
                alive = client.ping()
                print("pong" if alive else "no response")
                return 0 if alive else 1
            if args.cmd == "stats":
                print(json.dumps(client.stats(), indent=2))
                return 0
            if args.cmd == "shutdown":
                stopped = client.shutdown()
                print("daemon stopping" if stopped else "shutdown refused")
                return 0 if stopped else 1
    except DaemonError as exc:
        print(f"daemon error: {exc}", file=sys.stderr)
        return 1
    return 2  # pragma: no cover - argparse enforces the verb set


if __name__ == "__main__":
    sys.exit(main())
