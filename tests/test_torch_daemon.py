"""The port's compile daemon against the JAX package's, on the CPU.

``repro_torch.core.daemon`` and ``python -m repro_torch.daemon`` are copies
of the reference's modules. The first part runs the scenarios of
``tests/test_daemon.py`` against the port: admission control, stampede
coalescing, per-tenant deadlines, the unix-socket NDJSON protocol,
speculative-premapping attribution, trace rotation and cache pruning. The
second holds it to the reference on the same requests: deterministic
daemons of both packages give equal rows once the wall-clock fields (every
key ending in ``_s``) are removed, and the CLI round-trips
serve/submit/stats/ping/shutdown over a socket.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from repro.core import CGRA as JCGRA
from repro.core import running_example as jrunning_example
from repro.core.benchsuite import load_suite as jload_suite
from repro.core.daemon import CompileDaemon as JCompileDaemon
from repro.core.daemon import neighbor_options as jneighbor_options
from repro.core.mapper import clear_mapping_cache as jclear_mapping_cache
from repro.daemon import DEFAULT_SOCKET as JDEFAULT_SOCKET
from repro_torch.api import resolve_options
from repro_torch.core import CGRA, running_example
from repro_torch.core.benchsuite import load_suite
from repro_torch.core.daemon import (
    CompileDaemon,
    DaemonClient,
    DaemonError,
    DaemonServer,
    neighbor_options,
)
from repro_torch.core.mapper import clear_mapping_cache
from repro_torch.daemon import DEFAULT_SOCKET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: suite kernels that map in well under a second on 4x4 in deterministic
#: mode (cfd and hotspot3D take a minute or more there)
QUICK = ("aes", "backprop", "basicmath", "bitcount", "crc32", "fft", "gsm",
         "particlefilter", "sha2", "stringsearch")


@pytest.fixture(autouse=True)
def _fresh_memory_caches():
    clear_mapping_cache()
    jclear_mapping_cache()
    yield
    clear_mapping_cache()
    jclear_mapping_cache()


def _daemon(tmp_path=None, **kw):
    kw.setdefault("workers", 2)
    cache_dir = str(tmp_path / "cache") if tmp_path is not None else None
    return CompileDaemon(CGRA(4, 4), "fast", cache_dir=cache_dir, **kw)


def _untimed(row):
    """A row without its wall-clock fields (every key ending in ``_s``, at
    any depth)."""
    if isinstance(row, dict):
        return {k: _untimed(v) for k, v in row.items() if not k.endswith("_s")}
    if isinstance(row, list):
        return [_untimed(v) for v in row]
    return row


# ------------------------------------------------------------ basic serving

def test_daemon_compiles_and_stamps_service_block(tmp_path):
    with _daemon(tmp_path) as d:
        row = d.submit(running_example(), tenant="t0").wait(timeout=60)
    assert row["ok"] and row["failure"] is None
    svc = row["service"]
    assert svc["tenant"] == "t0" and svc["coalesced"] is False
    assert svc["queue_s"] >= 0
    assert row["metrics"]["cache"]["speculative"] is False


def test_daemon_warm_path_is_memory_hit(tmp_path):
    with _daemon(tmp_path) as d:
        cold = d.submit(running_example()).wait(timeout=60)
        warm = d.submit(running_example()).wait(timeout=60)
    assert cold["source"] == "solve" and warm["source"] == "memory"
    assert warm["ii"] == cold["ii"]
    assert d.stats.solves == 1 and d.stats.warm_memory == 1


def test_stop_cancels_queued_requests():
    d = _daemon()            # never started: requests stay queued
    t1 = d.submit(running_example())
    d.stop()
    row = t1.wait(timeout=5)
    assert row is not None and row["failure"] == "cancelled"
    t2 = d.submit(running_example())
    assert t2.wait(timeout=5)["failure"] == "overloaded"


# ------------------------------------------------------- stampede coalescing

def test_identical_concurrent_submits_coalesce_to_one_solve(tmp_path):
    n = 6
    d = _daemon(tmp_path)
    tickets = [d.submit(running_example(), tenant=f"t{i}") for i in range(n)]
    assert d.stats.coalesced == n - 1      # one leader, n-1 followers
    d.start()
    try:
        rows = [t.wait(timeout=60) for t in tickets]
    finally:
        d.stop()
    assert all(r is not None and r["ok"] for r in rows)
    assert d.stats.solves == 1             # the stampede cost ONE solve
    assert [r["service"]["coalesced"] for r in rows].count(True) == n - 1
    assert sorted(r["service"]["tenant"] for r in rows) == sorted(
        f"t{i}" for i in range(n))
    assert {r["ii"] for r in rows} == {rows[0]["ii"]}
    # followers never reach a worker: they are not counted as completed
    assert d.stats.completed + d.stats.coalesced == d.stats.submitted == n


def test_different_options_do_not_coalesce(tmp_path):
    d = _daemon(tmp_path)
    d.submit(running_example())
    d.submit(running_example(), max_route_hops=1)
    assert d.stats.coalesced == 0
    d.stop()


# --------------------------------------------------------- admission control

def test_queue_full_sheds_with_overloaded_code():
    d = _daemon(queue_limit=2)   # never started: the queue cannot drain
    dfgs = load_suite(names=["bitcount", "fft", "crc32"])
    t1 = d.submit(dfgs["bitcount"])
    t2 = d.submit(dfgs["fft"])
    t3 = d.submit(dfgs["crc32"])           # queue full -> shed immediately
    assert not t1.done and not t2.done
    assert t3.done
    row = t3.wait(timeout=1)
    assert row["ok"] is False
    assert row["failure"] == "overloaded"
    assert row["reason"].startswith("overloaded: queue full")
    assert d.stats.shed == 1
    d.stop()


def test_deadline_budget_admission_sheds_hopeless_requests():
    d = _daemon(queue_limit=100)
    d._ewma_service_s = 10.0               # pretend solves take 10s
    d.submit(running_example())
    t = d.submit(running_example(), deadline_s=0.5, max_route_hops=2)
    row = t.wait(timeout=1)
    assert row["failure"] == "overloaded"
    assert "deadline budget exceeded" in row["reason"]
    d.stop()


def test_deadline_expired_in_queue_returns_cancelled_without_solving():
    d = _daemon(workers=1)
    t = d.submit(running_example(), deadline_s=0.05, tenant="late")
    time.sleep(0.15)                       # burn the deadline while queued
    d.start()
    try:
        row = t.wait(timeout=10)
    finally:
        d.stop()
    assert row["ok"] is False and row["cancelled"] is True
    assert row["failure"] == "cancelled"
    assert "deadline expired in queue" in row["reason"]
    assert row["trace"]["windows_opened"] == 0
    assert d.stats.cancelled_in_queue == 1 and d.stats.solves == 0


# ------------------------------------------------------ speculative premapping

def test_neighbor_options_variants():
    opts = resolve_options("fast", max_route_hops=1, max_register_pressure=2)
    variants = neighbor_options(opts)
    assert sorted(v.max_route_hops for v in variants) == [0, 1, 2]
    assert any(v.max_register_pressure is None for v in variants)
    assert sorted(v.max_route_hops
                  for v in neighbor_options(resolve_options("fast"))) == [1]


def test_speculative_warm_is_attributed(tmp_path):
    with _daemon(tmp_path, workers=1) as d:
        first = d.submit(running_example()).wait(timeout=60)
        assert first["ok"] and first["service"]["speculative"] is False
        deadline = time.time() + 20
        while d.stats.speculative_warms < 1:    # idle thread premaps hops=1
            assert time.time() < deadline, "speculator never warmed"
            time.sleep(0.05)
        row = d.submit(running_example(), max_route_hops=1).wait(timeout=60)
    assert row["ok"]
    assert row["source"] in ("memory", "disk")
    assert row["service"]["speculative"] is True
    assert row["metrics"]["cache"]["speculative"] is True
    assert d.stats.speculative_hits == 1


def test_deterministic_options_disable_speculation():
    d = CompileDaemon(CGRA(4, 4), "deterministic-ci", workers=1)
    assert d.speculate is False
    d.stop()


# ------------------------------------------------------------ socket protocol

def test_socket_round_trip_and_error_isolation(tmp_path):
    sock = str(tmp_path / "d.sock")
    daemon = _daemon(tmp_path)
    server = DaemonServer(daemon, sock)
    server.start()
    try:
        with DaemonClient(sock) as c:
            assert c.ping()
            row = c.compile(running_example(), tenant="sock", deadline_s=30.0,
                            options={"max_route_hops": 1})
            assert row["ok"] and row["service"]["tenant"] == "sock"
            assert row["service"]["deadline_s"] == 30.0
            with pytest.raises(DaemonError):
                c.request({"op": "no-such-op"})
            with pytest.raises(DaemonError):
                c.request({"op": "compile", "dfg": {"bogus": True}})
            assert c.ping()
            stats = c.stats()
            assert stats["completed"] == 1 and stats["failed"] == 0
        with DaemonClient(sock) as c2:
            assert c2.shutdown()
        assert server._shutdown_requested.wait(timeout=5)
    finally:
        server.stop()
    assert not os.path.exists(sock)     # clean shutdown unlinks the socket


def test_socket_concurrent_clients_coalesce(tmp_path):
    sock = str(tmp_path / "d.sock")
    daemon = _daemon(tmp_path, workers=1)
    server = DaemonServer(daemon, sock)
    server.start()
    rows, lock = [], threading.Lock()

    def one(i):
        with DaemonClient(sock) as c:
            row = c.compile(running_example(), tenant=f"c{i}")
        with lock:
            rows.append(row)

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()
    assert len(rows) == 5 and all(r["ok"] for r in rows)
    assert daemon.stats.solves == 1


def test_stale_socket_file_is_reclaimed(tmp_path):
    sock = str(tmp_path / "stale.sock")
    with open(sock, "w"):
        pass                      # a crashed daemon's leftover path
    server = DaemonServer(_daemon(tmp_path), sock)
    server.start()
    try:
        with DaemonClient(sock) as c:
            assert c.ping()
    finally:
        server.stop()


def test_client_without_daemon_raises(tmp_path):
    with pytest.raises(DaemonError, match="cannot connect"):
        DaemonClient(str(tmp_path / "none.sock"))


# -------------------------------------------------------------- trace rotation

def test_trace_rotation_writes_loadable_segments(tmp_path):
    trace_dir = str(tmp_path / "traces")
    with _daemon(tmp_path, trace_dir=trace_dir, rotate_every=2) as d:
        for hops in (0, 1, 0, 1):
            assert d.submit(running_example(),
                            max_route_hops=hops).wait(timeout=60)["ok"]
    segments = sorted(os.listdir(trace_dir))
    assert len(segments) >= 2          # 4 requests / rotate_every=2, + final
    names = set()
    for fn in segments:
        with open(os.path.join(trace_dir, fn)) as f:
            doc = json.load(f)
        assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
        names |= {e["name"] for e in doc["traceEvents"]}
    assert "daemon.request" in names
    assert "compile" in names


def test_trace_report_reads_daemon_segments(tmp_path):
    trace_dir = str(tmp_path / "traces")
    with _daemon(tmp_path, trace_dir=trace_dir, rotate_every=100) as d:
        assert d.submit(running_example()).wait(timeout=60)["ok"]
    segments = os.listdir(trace_dir)
    assert segments
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_report.py"),
         "--check", os.path.join(trace_dir, sorted(segments)[0])],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------------- cache pruning

def test_daemon_prunes_disk_cache_during_idle_maintenance(tmp_path):
    d = _daemon(tmp_path, workers=1, cache_max_bytes=1, prune_every=1)
    with d:
        assert d.submit(running_example()).wait(timeout=60)["ok"]
        deadline = time.time() + 20
        while d.stats.cache_prunes < 1:    # piggybacks on the speculator
            assert time.time() < deadline, "maintenance never ran"
            time.sleep(0.05)
    assert d.stats.cache_evictions >= 1


# ------------------------------------------------ parity with the reference

def _deterministic_rows(make_daemon, load, make_example):
    """One request mix through a never-started deterministic daemon, then
    released: duplicates coalesce, one option variant does not, one request
    is shed by a full queue. Returns (rows in submit order, stats)."""
    suite = load(list(QUICK))
    d = make_daemon(queue_limit=len(QUICK) + 2)
    tickets = [d.submit(suite[n], tenant=f"t-{n}") for n in QUICK]
    tickets += [d.submit(suite["fft"], tenant="dup") for _ in range(3)]
    tickets.append(d.submit(make_example(), tenant="ex", deadline_s=60.0))
    tickets.append(d.submit(make_example(), max_route_hops=1))
    tickets.append(d.submit(make_example(), max_route_hops=2))   # queue full
    d.start()
    try:
        rows = [t.wait(timeout=120) for t in tickets]
    finally:
        d.stop()
    stats = d.stats_dict()
    stats.pop("ewma_service_s")
    return rows, stats


def test_deterministic_daemon_rows_match_reference():
    rows, stats = _deterministic_rows(
        lambda **kw: CompileDaemon(CGRA(4, 4), "deterministic-ci", workers=2, **kw),
        load_suite, running_example)
    jrows, jstats = _deterministic_rows(
        lambda **kw: JCompileDaemon(JCGRA(4, 4), "deterministic-ci", workers=2, **kw),
        jload_suite, jrunning_example)
    assert all(r is not None for r in rows + jrows)
    assert [_untimed(r) for r in rows] == [_untimed(r) for r in jrows]
    assert stats == jstats
    assert stats["coalesced"] == 3 and stats["shed"] == 1
    assert stats["solves"] == len(QUICK) + 2
    assert rows[-1]["failure"] == "overloaded"
    assert all(r["ok"] for r in rows[:-1])


@pytest.mark.parametrize("hops,pressure", [(0, None), (1, 2), (2, None)])
def test_neighbor_options_match_reference(hops, pressure):
    from repro.api import resolve_options as jresolve_options

    mine = neighbor_options(resolve_options(
        "fast", max_route_hops=hops, max_register_pressure=pressure))
    ref = jneighbor_options(jresolve_options(
        "fast", max_route_hops=hops, max_register_pressure=pressure))
    assert [v.as_dict() for v in mine] == [v.as_dict() for v in ref]


def test_default_socket_is_the_ports_own():
    assert DEFAULT_SOCKET == "/tmp/repro_torch-daemon.sock"
    assert DEFAULT_SOCKET != JDEFAULT_SOCKET


def _cli(*argv, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.daemon", *argv],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_round_trip(tmp_path):
    """``python -m repro_torch.daemon`` serve / ping / submit / stats /
    shutdown over a socket; the submitted rows equal the reference daemon's
    on the same requests."""
    sock = str(tmp_path / "d.sock")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.daemon", "serve", "--socket", sock,
         "--size", "4", "--profile", "deterministic-ci", "--workers", "2"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        while _cli("ping", "--socket", sock).returncode != 0:
            assert server.poll() is None, server.stderr.read()
            assert time.time() < deadline, "daemon never answered ping"
            time.sleep(0.1)
        sub = _cli("submit", "--socket", sock, "--bench", "fft", "--bench",
                   "bitcount", "--tenant", "ci", "--options", '{"max_route_hops": 1}')
        assert sub.returncode == 0, sub.stderr
        rows = [json.loads(line) for line in sub.stdout.splitlines()]
        assert [r["name"] for r in rows] == ["fft", "bitcount"]
        assert "# fft" in sub.stderr             # the per-row summary lines
        stats = _cli("stats", "--socket", sock)
        assert stats.returncode == 0
        counters = json.loads(stats.stdout)
        assert counters["submitted"] == counters["completed"] == counters["solves"] == 2
        down = _cli("shutdown", "--socket", sock)
        assert down.returncode == 0 and "daemon stopping" in down.stdout
        out, err = server.communicate(timeout=60)
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
    assert server.returncode == 0, err
    assert "repro_torch daemon serving on" in out and "daemon stopped" in out
    assert not os.path.exists(sock)
    assert _cli("ping", "--socket", sock).returncode == 1   # nothing listens now

    jd = JCompileDaemon(JCGRA(4, 4), "deterministic-ci", workers=2)
    jd.start()
    try:
        jsuite = jload_suite(["fft", "bitcount"])
        jrows = [jd.submit(jsuite[n], tenant="ci", max_route_hops=1).wait(timeout=60)
                 for n in ("fft", "bitcount")]
    finally:
        jd.stop()
    assert [_untimed(r) for r in rows] == [_untimed(r) for r in jrows]


def test_cli_rejects_bad_submissions(tmp_path):
    sock = str(tmp_path / "d.sock")
    bad = _cli("submit", "--socket", sock, "--bench", "fft", "--options", "[1]")
    assert bad.returncode == 2 and "bad --options JSON" in bad.stderr
    empty = _cli("submit", "--socket", sock)
    assert empty.returncode == 2 and "nothing to submit" in empty.stderr
    gone = _cli("stats", "--socket", sock)
    assert gone.returncode == 1 and "cannot connect" in gone.stderr
