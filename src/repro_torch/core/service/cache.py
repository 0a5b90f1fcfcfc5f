"""Persistent on-disk mapping cache (DESIGN.md §9).

Finished mappings are content-addressed: the key digest covers the cache
format version, the DFG's :meth:`~repro_torch.core.dfg.DFG.stable_hash`, the CGRA
dimensions and topology, the connectivity mode, the register-pressure limit,
and the II. Two processes compiling the same kernel therefore share work
through the filesystem — the second one reads a JSON entry instead of
re-solving — which is what makes repeated serve/bench runs cheap.

Design points (rationale in DESIGN.md §9):

* **One file per (key, II) entry.** Entries are immutable once written, so
  concurrent writers need no locking — the atomic ``os.replace`` of a
  same-content file is idempotent.
* **Versioned.** ``CACHE_VERSION`` participates in the digest, so a format
  bump orphans old entries rather than misreading them; ``prune()`` garbage-
  collects entries whose payload disagrees with the current version.
* **Corruption-tolerant.** A truncated/garbled/stale file is treated as a
  miss: the payload is parsed defensively, re-validated against the digest
  fields, and the mapping itself is re-checked by the caller before reuse.
  Bad files are deleted best-effort.

The in-memory LRU in ``core/mapper.py`` layers *over* this cache: memory is
checked first, disk second, and a disk hit is promoted into memory.
"""

from __future__ import annotations

import hashlib
import json
import os
import time as _time
from dataclasses import dataclass, field

# Bump whenever the entry payload schema or the key schema changes: old
# entries then simply stop matching (their digests embed the old version).
# v2: base key grew an arch token (heterogeneous architecture digest,
# DESIGN.md §10) — None on the paper's homogeneous grids.
# v3: base key grew the effective per-PE register-pressure token and the
# route-through hop allowance, and the payload grew a ``routes`` list
# (DESIGN.md §12) — pre-fix entries keyed on the scalar pressure limit alone
# could oversubscribe per-class register files and must never be served.
# v4: base key grew the resolved space-backend name (DESIGN.md §13.4) —
# exact and anneal placements are both valid but must never be served
# across engines, or backend provenance and benchmarks would lie.
# v5: the exact-check post-pass (DESIGN.md §14.4) now writes joint-backend
# mappings under the portfolio's own key when they strictly beat the
# portfolio II. The payload schema is unchanged, but pre-v5 entries may
# hold a provably suboptimal II for keys the adoption path would now
# overwrite; orphaning them lets certified results win deterministically.
CACHE_VERSION = 5

_ENTRY_SUFFIX = ".json"


@dataclass
class CacheStats:
    """Hit/miss counters surfaced in service reports and BENCH_* JSON."""

    hits: int = 0
    misses: int = 0
    writes: int = 0
    corrupt_dropped: int = 0
    evictions: int = 0

    def as_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "writes": self.writes,
            "corrupt_dropped": self.corrupt_dropped,
            "evictions": self.evictions,
        }


@dataclass
class DiskMappingCache:
    """Content-addressed store of finished mappings under ``root``.

    Example — share mappings between two processes::

        cache = DiskMappingCache("/tmp/maps")
        key = cache.entry_key(dfg.stable_hash(), 4, 4, "mesh", "strict", None)
        cache.put(key, ii=3, t_abs=sol.t_abs, placement=space.placement)
        # ... later, any process:
        hit = cache.get(key, lo_ii=3, hi_ii=8)   # -> (3, t_abs, placement)

    ``map_dfg(..., cache_dir=...)`` wires this in automatically; the class is
    public so services can pre-warm or inspect the store directly.
    """

    root: str
    stats: CacheStats = field(default_factory=CacheStats)

    # ------------------------------------------------------------------ keys
    @staticmethod
    def entry_key(
        dfg_hash: str,
        rows: int,
        cols: int,
        topology: str,
        connectivity: str,
        max_register_pressure: int | None,
        arch_token: str | None = None,
        pressure_token=None,
        max_route_hops: int = 0,
        space_backend: str = "exact",
    ) -> tuple:
        """Canonical base key; mirrors the in-memory LRU's ``_cache_base_key``.

        ``arch_token`` is ``CGRA.arch_token()``: None for the homogeneous
        paper machine, a digest of the capability layout otherwise.
        ``pressure_token`` is ``CGRA.pressure_token(max_register_pressure)``
        — the *effective per-PE* register-bound vector the mapper guarantees
        (None when the guarantee is off); ``max_route_hops`` keys the
        route-through allowance the mapping was searched under;
        ``space_backend`` is the *resolved* placement engine name ("auto"
        never reaches a key — DESIGN.md §13.4).
        """
        return (dfg_hash, rows, cols, topology, connectivity,
                max_register_pressure, arch_token, pressure_token,
                max_route_hops, space_backend)

    def _digest(self, base_key: tuple, ii: int) -> str:
        payload = json.dumps(
            {"v": CACHE_VERSION, "key": list(base_key), "ii": ii},
            sort_keys=True,
            separators=(",", ":"),
        )
        return hashlib.sha1(payload.encode()).hexdigest()

    def _path(self, base_key: tuple, ii: int) -> str:
        d = self._digest(base_key, ii)
        return os.path.join(self.root, d[:2], d + _ENTRY_SUFFIX)

    # ------------------------------------------------------------------- get
    def get(
        self, base_key: tuple, lo_ii: int, hi_ii: int
    ) -> tuple[int, list[int], list[int], list[tuple]] | None:
        """Best (lowest-II) entry for ``base_key`` with II in [lo_ii, hi_ii].

        Returns ``(ii, t_abs, placement, routes)`` or None — ``routes`` is
        the ``(src, dst, distance, n_movs)`` route-through spec list (empty
        for direct mappings; ``dfg.splice_routes`` rebuilds the rewritten
        DFG). Scans IIs ascending so a hit is always the best cached answer,
        matching the portfolio mapper's smallest-II-first preference.
        """
        for ii in range(lo_ii, hi_ii + 1):
            entry = self._read(base_key, ii)
            if entry is not None:
                self.stats.hits += 1
                return ii, entry[0], entry[1], entry[2]
        self.stats.misses += 1
        return None

    def _read(
        self, base_key: tuple, ii: int
    ) -> tuple[list[int], list[int], list[tuple]] | None:
        path = self._path(base_key, ii)
        try:
            with open(path, "r", encoding="utf-8") as f:
                payload = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError, UnicodeDecodeError):
            self._drop(path)
            return None
        # Defensive schema check: the digest embeds the key, but a partially
        # written or hand-edited file can still hold anything.
        try:
            if payload["version"] != CACHE_VERSION:
                raise ValueError("version mismatch")
            if payload["ii"] != ii or list(payload["key"]) != list(base_key):
                raise ValueError("key mismatch")
            t_abs = [int(t) for t in payload["t_abs"]]
            placement = [int(p) for p in payload["placement"]]
            if len(t_abs) != len(placement) or not t_abs:
                raise ValueError("length mismatch")
            routes = [
                (int(s), int(d), int(dist), int(n))
                for s, d, dist, n in payload.get("routes", [])
            ]
            if sum(n for *_rest, n in routes) >= len(t_abs):
                raise ValueError("routes longer than the mapping")
        except (KeyError, TypeError, ValueError):
            self._drop(path)
            return None
        return t_abs, placement, routes

    def _drop(self, path: str) -> None:
        self.stats.corrupt_dropped += 1
        try:
            os.unlink(path)
        except OSError:
            pass

    def invalidate(self, base_key: tuple, ii: int) -> None:
        """Drop one entry (e.g. it parsed fine but failed Mapping.validate).

        Without this, a schema-valid but semantically invalid entry would be
        re-read and re-rejected on every cold lookup, permanently defeating
        the cache for its key.
        """
        self._drop(self._path(base_key, ii))

    # ------------------------------------------------------------------- put
    def put(
        self, base_key: tuple, ii: int, t_abs: list[int], placement: list[int],
        *, routes=(),
    ) -> None:
        """Atomically persist one mapping (idempotent across processes).

        ``routes`` is the route-through spec (``Mapping.routes_spec()``);
        omit/empty for direct mappings.
        """
        path = self._path(base_key, ii)
        payload = {
            "version": CACHE_VERSION,
            "key": list(base_key),
            "ii": ii,
            "t_abs": list(t_abs),
            "placement": list(placement),
            "routes": [list(r) for r in routes],
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, separators=(",", ":"))
            os.replace(tmp, path)
            self.stats.writes += 1
        except OSError:
            # cache writes are best-effort: a full/read-only disk must never
            # fail a compilation
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # ------------------------------------------------------------- maintenance
    def prune(
        self, max_bytes: int | None = None, max_age_s: float | None = None,
    ) -> int:
        """Delete stale files and (optionally) bound the store's size/age.

        Always removes version-mismatched entries and orphaned ``*.tmp.<pid>``
        files (a writer killed between open and replace) — version-bumped
        entries are unreachable anyway (the digest changed), so this just
        reclaims the disk. An in-flight concurrent write losing its temp
        merely skips that best-effort write.

        With ``max_age_s``, entries whose mtime is older than that many
        seconds are evicted. With ``max_bytes``, surviving entries are
        evicted LRU-by-mtime (oldest first) until the store fits the budget
        — ``os.replace`` on a read path never touches mtime, so mtime order
        is write/refresh order, the same approximation a long-running daemon
        wants for "least recently produced". Evictions are counted in
        ``stats.evictions`` (mirroring the in-memory LRU's counter); stale/
        corrupt removals stay out of that counter. Returns the total number
        of files removed. All removals are best-effort: a concurrently
        deleted file is not an error.
        """
        removed = 0
        now = _time.time()
        survivors: list[tuple[float, int, str]] = []  # (mtime, size, path)
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for fn in filenames:
                path = os.path.join(dirpath, fn)
                if f"{_ENTRY_SUFFIX}.tmp." in fn:
                    try:
                        os.unlink(path)
                        removed += 1
                    except OSError:
                        pass
                    continue
                if not fn.endswith(_ENTRY_SUFFIX):
                    continue
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        payload = json.load(f)
                    ok = payload.get("version") == CACHE_VERSION
                except (OSError, ValueError, UnicodeDecodeError):
                    ok = False
                if not ok:
                    try:
                        os.unlink(path)
                        removed += 1
                    except OSError:
                        pass
                    continue
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                if max_age_s is not None and now - st.st_mtime > max_age_s:
                    if self._evict(path):
                        removed += 1
                    continue
                survivors.append((st.st_mtime, st.st_size, path))
        if max_bytes is not None:
            total = sum(size for _mt, size, _p in survivors)
            for _mtime, size, path in sorted(survivors):
                if total <= max_bytes:
                    break
                if self._evict(path):
                    removed += 1
                    total -= size
        return removed

    def _evict(self, path: str) -> bool:
        try:
            os.unlink(path)
        except OSError:
            return False
        self.stats.evictions += 1
        return True

    def __len__(self) -> int:
        count = 0
        for _dirpath, _dirnames, filenames in os.walk(self.root):
            count += sum(1 for fn in filenames if fn.endswith(_ENTRY_SUFFIX))
        return count


def resolve_cache_dir(cache_dir: str | None) -> str | None:
    """Resolve the effective cache directory.

    Precedence: explicit argument > ``REPRO_CACHE_DIR`` env var > disabled.
    An empty string in either position disables the disk cache (lets CI force
    cold runs without unsetting the variable).
    """
    if cache_dir is not None:
        return cache_dir or None
    env = os.environ.get("REPRO_CACHE_DIR")
    return env or None
