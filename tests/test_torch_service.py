"""The port's service layer against the JAX package's, on the CPU.

``repro_torch.core.service`` (the persistent mapping cache, the process-pool
batch compiler, window striping and racing) and ``core/exact_backends``
(the exact joint solver and its optimality certificates) are copies of the
reference's modules. Here they are held to the reference on the same
inputs, with exact equality throughout: cache keys, entry files and hits
in both directions, deterministic batch rows with their timing fields
removed, and the solver's and certifier's verdicts. The pool is held to
its results, never to its speed.
"""

import dataclasses
import os
import threading

import pytest

from repro.core import CGRA as JCGRA
from repro.core import map_dfg as jmap_dfg
from repro.core import running_example as jrunning_example
from repro.core.benchsuite import load_suite as jload_suite
from repro.core.exact_backends import certify_mapping as jcertify_mapping
from repro.core.exact_backends import solve_joint as jsolve_joint
from repro.core.exact_backends.joint import grid_automorphisms as jgrid_automorphisms
from repro.core.mapper import clear_mapping_cache as jclear_mapping_cache
from repro.core.service import CACHE_VERSION as JCACHE_VERSION
from repro.core.service import CompileJob as JCompileJob
from repro.core.service import DiskMappingCache as JDiskMappingCache
from repro.core.service import compile_many as jcompile_many
from repro.core.service import map_dfg_racing as jmap_dfg_racing
from repro_torch.core import CGRA, map_dfg, running_example
from repro_torch.core.benchsuite import load_suite
from repro_torch.core.exact_backends import (
    Certificate,
    certify_mapping,
    solve_joint,
    verify_certificate,
)
from repro_torch.core.exact_backends.joint import grid_automorphisms
from repro_torch.core.mapper import _cache_base_key, clear_mapping_cache
from repro_torch.core.service import (
    CACHE_VERSION,
    CompileJob,
    DiskMappingCache,
    compile_many,
    map_dfg_racing,
    resolve_cache_dir,
)
from repro_torch.core.simulate import check_equivalence

#: suite kernels that map in well under a second on 4x4 in deterministic
#: mode (cfd and hotspot3D take a minute or more there)
QUICK = ("aes", "backprop", "bitcount", "fft", "gsm", "sha2")


@pytest.fixture(autouse=True)
def _fresh_memory_caches():
    clear_mapping_cache()
    jclear_mapping_cache()
    yield
    clear_mapping_cache()
    jclear_mapping_cache()


def _untimed(row):
    """A row without its wall-clock fields (every key ending in ``_s``, at
    any depth)."""
    if isinstance(row, dict):
        return {k: _untimed(v) for k, v in row.items() if not k.endswith("_s")}
    if isinstance(row, list):
        return [_untimed(v) for v in row]
    return row


def _key(mapping):
    return mapping.ii, mapping.t_abs, mapping.placement


def _key_row(job):
    return job.name, job.ii, job.t_abs, job.placement, job.routes


# -------------------------------------------------------------- disk cache

def test_cache_version_key_and_path_match_reference(tmp_path):
    assert CACHE_VERSION == JCACHE_VERSION
    dfg = load_suite(["gsm"])["gsm"]
    base = _cache_base_key(dfg, CGRA(4, 4), "strict", None, 0, "exact")
    mine, ref = DiskMappingCache(str(tmp_path)), JDiskMappingCache(str(tmp_path))
    jbase = JDiskMappingCache.entry_key(
        dfg.stable_hash(), 4, 4, "mesh", "strict", None,
        None, CGRA(4, 4).pressure_token(None), 0, "exact")
    assert base == DiskMappingCache.entry_key(
        dfg.stable_hash(), 4, 4, "mesh", "strict", None,
        None, CGRA(4, 4).pressure_token(None), 0, "exact") == jbase
    for ii in (3, 4, 9):
        assert mine._path(base, ii) == ref._path(base, ii)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_disk_cache_entries_are_served_across_packages(tmp_path, writer):
    """An entry written by one package is a disk hit in the other, with the
    same mapping; the entry files are byte-for-byte the same format."""
    name = "gsm" if writer == "reference" else "fft"
    dfg, jdfg = load_suite([name])[name], jload_suite([name])[name]
    root = str(tmp_path)
    first, second = ((jmap_dfg, jdfg, JCGRA), (map_dfg, dfg, CGRA))
    if writer == "port":
        first, second = second, first
    fn, graph, grid = first
    cold = fn(graph, grid(4, 4), cache_dir=root)
    assert cold.ok and not cold.stats.disk_cache_hit
    fn, graph, grid = second
    warm = fn(graph, grid(4, 4), cache_dir=root)
    assert warm.stats.disk_cache_hit and warm.stats.backend == "disk-cache"
    assert _key(warm.mapping) == _key(cold.mapping)
    assert warm.mapping.validate() == []
    assert len(DiskMappingCache(root)) == len(JDiskMappingCache(root)) == 1


def test_resolve_cache_dir_precedence(monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", "/from/env")
    assert resolve_cache_dir(None) == "/from/env"
    assert resolve_cache_dir("/explicit") == "/explicit"
    assert resolve_cache_dir("") is None
    monkeypatch.setenv("REPRO_CACHE_DIR", "")
    assert resolve_cache_dir(None) is None


def test_disk_cache_prune_matches_reference(tmp_path):
    counts = []
    for cls, sub in ((DiskMappingCache, "port"), (JDiskMappingCache, "ref")):
        store = cls(str(tmp_path / sub))
        keys = [store.entry_key(f"dfg{i}", 2, 2, "mesh", "strict", None)
                for i in range(4)]
        for i, key in enumerate(keys):
            store.put(key, 2, [0, 1], [0, 1])
            os.utime(store._path(key, 2), (1000 + i, 1000 + i))
        size = os.path.getsize(store._path(keys[0], 2))
        removed = store.prune(max_bytes=2 * size)
        counts.append((removed, len(store), store.stats.evictions,
                       [store.get(k, 2, 2) is not None for k in keys]))
    assert counts[0] == counts[1] == (2, 2, 2, [False, False, True, True])


# ----------------------------------------------------------- batch compiler

def _jobs(make_job, load, grid, names=QUICK):
    suite = load(list(names))
    return [make_job(suite[n], grid(4, 4)) for n in names]


def test_compile_many_deterministic_rows_match_reference():
    mine = compile_many(_jobs(CompileJob, load_suite, CGRA), jobs=1,
                        deterministic=True)
    ref = jcompile_many(_jobs(JCompileJob, jload_suite, JCGRA), jobs=1,
                        deterministic=True)
    assert mine.ok and ref.ok and mine.num_workers == ref.num_workers == 1
    assert mine.cache_counters == ref.cache_counters
    for a, b in zip(mine.jobs, ref.jobs):
        assert _untimed(dataclasses.asdict(a)) == _untimed(dataclasses.asdict(b))
    assert _untimed(mine.as_dict()) == _untimed(ref.as_dict())


def test_compile_many_pool_smoke_and_cross_process_cache(tmp_path):
    """Two forked workers: every job ok, the rows of deterministic jobs are
    the sequential run's, and a second pool reads back what the first one
    wrote (exact counters)."""
    batch = _jobs(CompileJob, load_suite, CGRA, ("bitcount", "fft", "gsm"))
    seq = compile_many(batch, jobs=1, deterministic=True)
    pool = compile_many(batch, jobs=2, deterministic=True)
    assert pool.ok and pool.num_workers == 2
    assert [_key_row(j) for j in pool.jobs] == [_key_row(j) for j in seq.jobs]
    cold = compile_many(batch, jobs=2, cache_dir=str(tmp_path), deadline_s=30)
    assert cold.ok and cold.cache_counters["solved"] == 3
    clear_mapping_cache()
    warm = compile_many(batch, jobs=2, cache_dir=str(tmp_path), deadline_s=30)
    assert warm.ok and warm.cache_counters["disk_hits"] == 3
    assert [_key_row(j) for j in warm.jobs] == [_key_row(j) for j in cold.jobs]


def test_compile_many_failure_and_cancellation_rows_match_reference():
    failing = (compile_many([CompileJob(load_suite(["bitcount"])["bitcount"], CGRA(1, 1),
                                        options={"max_ii": 4})], jobs=1, deadline_s=5),
               jcompile_many([JCompileJob(jload_suite(["bitcount"])["bitcount"], JCGRA(1, 1),
                                          options={"max_ii": 4})], jobs=1, deadline_s=5))
    for report in failing:
        assert not report.ok and report.cache_counters["failed"] == 1
    assert failing[0].jobs[0].reason == failing[1].jobs[0].reason
    cancel = threading.Event()
    cancel.set()
    mine = compile_many(_jobs(CompileJob, load_suite, CGRA, ("bitcount", "fft")),
                        jobs=1, cancel=cancel)
    ref = jcompile_many(_jobs(JCompileJob, jload_suite, JCGRA, ("bitcount", "fft")),
                        jobs=1, cancel=cancel)
    assert [j.cancelled for j in mine.jobs] == [j.cancelled for j in ref.jobs] == [True, True]
    assert [_untimed(j.as_dict()) for j in mine.jobs] == [
        _untimed(j.as_dict()) for j in ref.jobs]


def test_window_striping_and_racing_match_reference():
    dfg, cgra = running_example(), CGRA(2, 2)
    jdfg, jcgra = jrunning_example(), JCGRA(2, 2)
    for offset in range(3):
        kw = dict(deterministic=True, window_offset=offset, window_stride=3)
        mine, ref = map_dfg(dfg, cgra, **kw), jmap_dfg(jdfg, jcgra, **kw)
        assert mine.ok == ref.ok
        if mine.ok:
            assert _key(mine.mapping) == _key(ref.mapping)
        assert mine.stats.windows_opened == ref.stats.windows_opened
    # deterministic racing falls back to the plain search in both packages
    mine = map_dfg_racing(dfg, cgra, workers=2, deterministic=True)
    ref = jmap_dfg_racing(jdfg, jcgra, workers=2, deterministic=True)
    assert _key(mine.mapping) == _key(ref.mapping)
    raced = map_dfg_racing(dfg, cgra, workers=2, time_budget_s=30)
    assert raced.ok and raced.mapping.validate() == []


# ------------------------------------------------------------- exact backends

@pytest.mark.parametrize("case", ["unsat_2x2_ii3", "sat_2x2_ii4", "unknown_sha1_ii2"])
def test_solve_joint_matches_reference(case):
    if case == "unknown_sha1_ii2":
        args = (load_suite(["sha1"])["sha1"], CGRA(4, 4), 2)
        jargs = (jload_suite(["sha1"])["sha1"], JCGRA(4, 4), 2)
        kw = {"node_budget": 50}
    else:
        ii = 3 if case.startswith("unsat") else 4
        args, jargs, kw = (running_example(), CGRA(2, 2), ii), (
            jrunning_example(), JCGRA(2, 2), ii), {}
    mine, ref = solve_joint(*args, **kw), jsolve_joint(*jargs, **kw)
    assert (mine.status, mine.nodes_visited) == (ref.status, ref.nodes_visited)
    assert (mine.mapping is None) == (ref.mapping is None)
    if mine.mapping is not None:
        assert _key(mine.mapping) == _key(ref.mapping)
        assert mine.mapping.validate() == []
        check_equivalence(mine.mapping)


def test_grid_automorphisms_match_reference():
    for grid in ((4, 4, "mesh"), (3, 4, "mesh"), (4, 4, "torus")):
        mine = grid_automorphisms(CGRA(grid[0], grid[1], topology=grid[2]))
        ref = jgrid_automorphisms(JCGRA(grid[0], grid[1], topology=grid[2]))
        assert [list(p) for p in mine] == [list(p) for p in ref]


def _cert_view(cert):
    return _untimed({k: v for k, v in cert.as_dict().items() if k != "probes"}), [
        _untimed(p) for p in cert.probes]


@pytest.mark.parametrize("case", ["bound_bitcount", "better_found_2x2", "timeout_2x2"])
def test_certify_mapping_matches_reference(case):
    """The small cases of tests/test_certificates.py (not its slow sweep):
    the same status, optimum, probes and adopted mapping in both packages.
    The timeout case starves the 2x2 refutation of its node budget where
    the reference test starves susan's (whose deterministic 4x4 mapping
    alone takes half a minute here)."""
    if case == "bound_bitcount":
        dfg, jdfg = load_suite(["bitcount"])["bitcount"], jload_suite(["bitcount"])["bitcount"]
        m = map_dfg(dfg, CGRA(4, 4), deterministic=True, use_cache=False)
        jm = jmap_dfg(jdfg, JCGRA(4, 4), deterministic=True, use_cache=False)
        assert _key(m.mapping) == _key(jm.mapping)
        args, jargs, kw = (dfg, CGRA(4, 4), m.mapping), (jdfg, JCGRA(4, 4), jm.mapping), {}
    else:
        worse = solve_joint(running_example(), CGRA(2, 2), 5).mapping
        jworse = jsolve_joint(jrunning_example(), JCGRA(2, 2), 5).mapping
        args, jargs = ((running_example(), CGRA(2, 2), worse),
                       (jrunning_example(), JCGRA(2, 2), jworse))
        kw = {"node_budget": 5} if case == "timeout_2x2" else {}
    cert, better = certify_mapping(*args, deterministic=True, **kw)
    jcert, jbetter = jcertify_mapping(*jargs, deterministic=True, **kw)
    want = {"bound_bitcount": "optimal", "better_found_2x2": "better-found",
            "timeout_2x2": "timeout"}[case]
    assert cert.status == jcert.status == want
    assert _cert_view(cert) == _cert_view(jcert)
    assert (better is None) == (jbetter is None)
    if better is not None:
        assert _key(better) == _key(jbetter)
        assert better.validate() == []
    if case == "timeout_2x2":
        assert cert.ii_opt is None and cert.m_ii <= cert.ii_lower_bound <= cert.ii
    assert verify_certificate(cert, args[0], args[1]) == []
    assert verify_certificate(Certificate.from_dict(jcert.as_dict()), args[0], args[1]) == []
