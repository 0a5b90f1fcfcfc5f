"""Unix-socket NDJSON transport for the compile daemon (DESIGN.md §16.1).

The wire format is deliberately boring: an ``AF_UNIX`` stream socket carrying
newline-delimited JSON, one object per line, one response line per request
line. A connection may pipeline any number of requests; the daemon handles
each connection on its own thread (the compile work itself is bounded by the
daemon's worker pool and admission control, so connection threads only ever
block on queue tickets, not on solves they started).

Request objects (``op`` selects the verb):

``{"op": "compile", "dfg": {...}, "tenant": ..., "deadline_s": ...,
   "options": {...}}``
    ``dfg`` is the parsed form of :meth:`repro_torch.core.dfg.DFG.to_json`;
    ``options`` is a dict of per-request :class:`CompileOptions` overrides
    (e.g. ``{"max_route_hops": 1}``). Response: ``{"ok": true, "result":
    <CompileResult row>}`` — shed/cancelled requests are *successful
    responses* carrying a failed row (``result.failure == "overloaded"`` /
    ``"cancelled"``), so transport errors and service decisions never mix.
``{"op": "ping"}``
    Liveness probe. Response ``{"ok": true, "pong": true}``.
``{"op": "stats"}``
    Daemon counters. Response ``{"ok": true, "stats": {...}}``
    (:meth:`CompileDaemon.stats_dict`).
``{"op": "shutdown"}``
    Graceful stop: response ``{"ok": true, "stopping": true}`` is written
    first, then the server drains and exits its serve loop.

A malformed line or unknown op produces ``{"ok": false, "error": "..."}``
on that line and the connection stays usable — one bad client request must
never poison a pipelined neighbor or crash the daemon.
"""

from __future__ import annotations

import json
import os
import socket
import threading

from ..dfg import DFG
from .server import CompileDaemon

__all__ = ["DaemonServer", "serve"]

#: Per-line size cap (a DFG of thousands of nodes is ~100 KB; 32 MB is
#: generous headroom while still bounding a malicious/broken client).
MAX_LINE_BYTES = 32 * 1024 * 1024


class DaemonServer:
    """Serves one :class:`CompileDaemon` over a unix socket.

    Example::

        server = DaemonServer(daemon, "/tmp/repro_torch.sock")
        server.start()          # background accept loop
        ...
        server.stop()           # close socket, join threads, stop the daemon
    """

    def __init__(self, daemon: CompileDaemon, socket_path: str) -> None:
        self.daemon = daemon
        self.socket_path = socket_path
        self._sock: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conn_threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._shutdown_requested = threading.Event()

    # ---------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Bind the socket and start accepting (daemon workers start too)."""
        if self._sock is not None:
            return
        # a stale socket file from a crashed daemon would make bind fail;
        # only unlink when nothing is listening behind it
        if os.path.exists(self.socket_path):
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.settimeout(0.25)
                probe.connect(self.socket_path)
            except OSError:
                os.unlink(self.socket_path)
            else:
                probe.close()
                raise RuntimeError(
                    f"a daemon is already listening on {self.socket_path}")
            finally:
                probe.close()
        self.daemon.start()
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(self.socket_path)
        sock.listen(64)
        sock.settimeout(0.2)  # lets the accept loop observe _stop
        self._sock = sock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="repro-daemon-accept", daemon=True)
        self._accept_thread.start()

    def stop(self) -> None:
        """Stop accepting, join connection threads, stop the daemon."""
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        for t in self._conn_threads:
            t.join(timeout=5.0)
        self._conn_threads.clear()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        self.daemon.stop()

    def serve_forever(self) -> None:
        """Block until a client sends ``shutdown`` (the CLI serve mode)."""
        if self._sock is None:
            self.start()
        self._shutdown_requested.wait()
        self.stop()

    # ------------------------------------------------------------------- loops
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # socket closed under us during stop()
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="repro-daemon-conn", daemon=True)
            t.start()
            self._conn_threads.append(t)
            # opportunistic reaping keeps the list bounded on long sessions
            self._conn_threads = [x for x in self._conn_threads
                                  if x.is_alive()]

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            rfile = conn.makefile("rb")
            try:
                while not self._stop.is_set():
                    line = rfile.readline(MAX_LINE_BYTES + 1)
                    if not line:
                        return  # client hung up
                    if len(line) > MAX_LINE_BYTES:
                        self._send(conn, {"ok": False,
                                          "error": "request line too large"})
                        return
                    line = line.strip()
                    if not line:
                        continue
                    resp, shutdown = self._dispatch(line)
                    self._send(conn, resp)
                    if shutdown:
                        self._shutdown_requested.set()
                        return
            except OSError:
                return  # torn connection: nothing to clean up
            finally:
                rfile.close()

    @staticmethod
    def _send(conn: socket.socket, obj: dict) -> None:
        conn.sendall(json.dumps(obj).encode() + b"\n")

    # ---------------------------------------------------------------- dispatch
    def _dispatch(self, line: bytes) -> tuple[dict, bool]:
        """One request line → (response object, shutdown?). Never raises."""
        try:
            msg = json.loads(line)
            if not isinstance(msg, dict):
                raise ValueError("request must be a JSON object")
            op = msg.get("op")
            if op == "ping":
                return {"ok": True, "pong": True}, False
            if op == "stats":
                return {"ok": True, "stats": self.daemon.stats_dict()}, False
            if op == "shutdown":
                return {"ok": True, "stopping": True}, True
            if op == "compile":
                return {"ok": True, "result": self._compile(msg)}, False
            raise ValueError(f"unknown op {op!r}")
        except Exception as exc:
            return {"ok": False,
                    "error": f"{type(exc).__name__}: {exc}"}, False

    def _compile(self, msg: dict) -> dict:
        dfg = DFG.from_json(json.dumps(msg["dfg"]))
        overrides = msg.get("options") or {}
        if not isinstance(overrides, dict):
            raise ValueError("options must be an object of field overrides")
        ticket = self.daemon.submit(
            dfg,
            tenant=msg.get("tenant"),
            deadline_s=msg.get("deadline_s"),
            **overrides,
        )
        # connection threads block on tickets, never on solves they own —
        # deadline requests resolve by their deadline, the rest by budget
        return ticket.wait()


def serve(daemon: CompileDaemon, socket_path: str) -> DaemonServer:
    """Convenience: build, start, and return a :class:`DaemonServer`."""
    server = DaemonServer(daemon, socket_path)
    server.start()
    return server
