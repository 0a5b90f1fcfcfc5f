"""Client for the compile-daemon unix socket (DESIGN.md §16.1).

A thin, dependency-free NDJSON requester::

    from repro_torch.core.daemon import DaemonClient

    with DaemonClient("/tmp/repro_torch.sock") as client:
        assert client.ping()
        row = client.compile(dfg, tenant="ci", deadline_s=5.0,
                             options={"max_route_hops": 1})
        assert row["ok"] or row["failure"] in ("overloaded", "cancelled")

One client holds one connection; requests on it are serialized (send a line,
read a line). Use one client per thread for concurrent load — connections
are cheap and the daemon handles each on its own thread.
"""

from __future__ import annotations

import json
import socket

from ..dfg import DFG

__all__ = ["DaemonClient", "DaemonError"]


class DaemonError(RuntimeError):
    """A transport- or protocol-level failure (NOT a failed compile row —
    shed and cancelled requests come back as ordinary rows with their
    machine-readable ``failure`` code set)."""


class DaemonClient:
    """One NDJSON connection to a :class:`~repro_torch.core.daemon.DaemonServer`."""

    def __init__(self, socket_path: str, *, timeout_s: float | None = None):
        self.socket_path = socket_path
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if timeout_s is not None:
            self._sock.settimeout(timeout_s)
        try:
            self._sock.connect(socket_path)
        except OSError as exc:
            self._sock.close()
            raise DaemonError(
                f"cannot connect to daemon at {socket_path}: {exc}"
            ) from None
        self._rfile = self._sock.makefile("rb")

    # ---------------------------------------------------------------- plumbing
    def request(self, msg: dict) -> dict:
        """Send one request object, return the daemon's response object.

        Raises :class:`DaemonError` on transport failure or an
        ``{"ok": false}`` protocol response.
        """
        try:
            self._sock.sendall(json.dumps(msg).encode() + b"\n")
            line = self._rfile.readline()
        except OSError as exc:
            raise DaemonError(f"daemon connection failed: {exc}") from None
        if not line:
            raise DaemonError("daemon closed the connection")
        try:
            resp = json.loads(line)
        except ValueError as exc:
            raise DaemonError(f"malformed daemon response: {exc}") from None
        if not resp.get("ok"):
            raise DaemonError(resp.get("error", "daemon request failed"))
        return resp

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self) -> "DaemonClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------- verbs
    def ping(self) -> bool:
        return bool(self.request({"op": "ping"}).get("pong"))

    def stats(self) -> dict:
        return self.request({"op": "stats"})["stats"]

    def compile(
        self,
        dfg: DFG,
        *,
        tenant: str | None = None,
        deadline_s: float | None = None,
        options: dict | None = None,
    ) -> dict:
        """Compile one DFG; returns the full CompileResult row dict.

        ``options`` is a dict of per-request :class:`CompileOptions` field
        overrides. Admission decisions arrive as rows, not exceptions:
        check ``row["failure"]`` for ``"overloaded"`` (back off and retry)
        and ``"cancelled"`` (deadline expired before a worker was free).
        """
        msg: dict = {"op": "compile", "dfg": json.loads(dfg.to_json())}
        if tenant is not None:
            msg["tenant"] = tenant
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        if options:
            msg["options"] = options
        return self.request(msg)["result"]

    def shutdown(self) -> bool:
        """Ask the daemon to stop; True when it acknowledged."""
        return bool(self.request({"op": "shutdown"}).get("stopping"))
