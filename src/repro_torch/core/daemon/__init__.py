"""Persistent compile daemon (DESIGN.md §16).

A long-running compile server over one :class:`~repro_torch.api.Compiler` session:
bounded-queue admission control with machine-readable ``overloaded`` sheds,
per-tenant deadlines, in-flight coalescing of identical requests, idle-time
speculative premapping with hit attribution, unix-socket NDJSON transport,
and bounded disk-cache/trace maintenance for unbounded lifetimes.

* :class:`CompileDaemon` — the in-process server core (``server.py``)
* :class:`DaemonServer` / :func:`serve` — unix-socket transport
  (``protocol.py``)
* :class:`DaemonClient` — the matching client (``client.py``)
* ``python -m repro_torch.daemon`` — the CLI frontend (serve / submit / stats /
  shutdown)
"""

from .client import DaemonClient, DaemonError
from .protocol import DaemonServer, serve
from .server import CompileDaemon, DaemonStats, Ticket, neighbor_options

__all__ = [
    "CompileDaemon",
    "DaemonClient",
    "DaemonError",
    "DaemonServer",
    "DaemonStats",
    "Ticket",
    "neighbor_options",
    "serve",
]
