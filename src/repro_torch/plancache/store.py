"""Two-tier persistent plan store: in-memory LRU front, on-disk JSON back.

Layout: one ``<digest>.json`` file per entry under
``$REPRO_PLAN_CACHE_DIR`` (default ``~/.cache/repro-plancache``), plus a
``_stats.json`` accumulating cumulative hit/miss counters across processes
(flushed explicitly — the AOT CLI and the integration points call
:meth:`PlanCacheStore.flush_stats`).

Entry format::

    {"key": <digest>, "schema": <int>, "created": <unix ts>,
     "meta": {"template": ..., "shape": [...], "hw": <df digest>,
              "hw_name": ..., ...},
     "payload": {...}}              # arbitrary JSON (serialized PlanResult,
                                    # block tuple, mesh ranking, ...)

``meta`` is what ``ls``/``nearest`` scan; ``payload`` is what a hit
returns.  Set ``REPRO_PLAN_CACHE=off`` to bypass the store entirely
(every lookup counts as ``bypassed`` and planning proceeds uncached).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.obs import metrics

from . import keying

ENV_DIR = "REPRO_PLAN_CACHE_DIR"
ENV_TOGGLE = "REPRO_PLAN_CACHE"
_OFF_VALUES = ("0", "off", "false", "no", "disable", "disabled")
STATS_FILE = "_stats.json"
QUARANTINE_DIR = "quarantine"


def default_cache_dir() -> Path:
    env = os.environ.get(ENV_DIR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-plancache"


def cache_enabled() -> bool:
    return os.environ.get(ENV_TOGGLE, "").lower() not in _OFF_VALUES


@dataclass
class CacheStats:
    hits_mem: int = 0
    hits_disk: int = 0
    misses: int = 0
    bypassed: int = 0
    puts: int = 0
    warm_starts: int = 0
    corrupt: int = 0         # entries quarantined (decode/checksum/validate)

    @property
    def hits(self) -> int:
        return self.hits_mem + self.hits_disk

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> Dict[str, int]:
        return {"hits_mem": self.hits_mem, "hits_disk": self.hits_disk,
                "misses": self.misses, "bypassed": self.bypassed,
                "puts": self.puts, "warm_starts": self.warm_starts,
                "corrupt": self.corrupt}

    def add(self, other: Dict[str, int]) -> None:
        for k, v in other.items():
            if hasattr(self, k):
                setattr(self, k, getattr(self, k) + int(v))


class PlanCacheStore:
    """The two-tier cache: an LRU dict of deserialized entries in front of
    the per-entry JSON files."""

    def __init__(self, root: Optional[Path] = None, *,
                 mem_capacity: int = 256,
                 enabled: Optional[bool] = None) -> None:
        self.root = Path(root) if root is not None else default_cache_dir()
        self.mem_capacity = mem_capacity
        self.enabled = cache_enabled() if enabled is None else enabled
        self._mem: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.stats = CacheStats()
        self._flushed = CacheStats()   # what has already been persisted
        self._meta: Optional[List[Tuple[str, Dict[str, Any]]]] = None
        self._meta_mtime = 0

    # ----------------------------------------------------------- paths
    def _path(self, key: str) -> Path:
        return self.root / f"{key}.json"

    # ----------------------------------------------------- integrity
    def quarantine(self, key: str, cause: str) -> None:
        """Move a corrupt/invalid entry to ``<root>/quarantine/`` (atomic
        rename, preserved for debugging) and count it.  Used by the read
        path on decode/checksum failures and by the cache layer when a
        deserialized plan fails :func:`~repro_torch.plancache.validate
        .validate_plan`."""
        self._mem.pop(key, None)
        self._quarantine_path(self._path(key), cause)

    def _quarantine_path(self, path: Path, cause: str) -> None:
        self.stats.corrupt += 1
        metrics.inc("plancache_corrupt_entries_total", cause=cause)
        try:
            qdir = self.root / QUARANTINE_DIR
            qdir.mkdir(parents=True, exist_ok=True)
            os.replace(path, qdir / path.name)
        except OSError:
            with contextlib.suppress(OSError):
                path.unlink()
        self._meta = None          # the index no longer matches the dir

    @staticmethod
    def _checksum_ok(ent: Dict[str, Any]) -> bool:
        """Verify the per-entry payload checksum when present.  Entries
        written before the checksum existed carry no ``sum`` field and pass
        (back-compat: schema is unchanged — the payload layout did not)."""
        want = ent.get("sum")
        if want is None:
            return True
        return want == keying.digest_of(ent.get("payload"))

    # ----------------------------------------------------------- get/put
    def get(self, key: str) -> Optional[Dict[str, Any]]:
        if not self.enabled:
            self.stats.bypassed += 1
            metrics.inc("plancache_get_total", result="bypass")
            return None
        ent = self._mem.get(key)
        if ent is not None:
            self._mem.move_to_end(key)
            self.stats.hits_mem += 1
            metrics.inc("plancache_get_total", result="hit_mem")
            return ent
        path = self._path(key)
        if path.is_file():
            try:
                ent = json.loads(path.read_text())
            except json.JSONDecodeError:
                self.quarantine(key, "decode")
                ent = None
            except OSError:
                metrics.inc("plancache_io_errors_total", op="get")
                ent = None
            if ent is not None and ent.get("schema") != keying.SCHEMA_VERSION:
                ent = None           # stale schema: a plain miss, not corrupt
            if ent is not None and not self._checksum_ok(ent):
                self.quarantine(key, "checksum")
                ent = None
            if ent is not None:
                self._remember(key, ent)
                self.stats.hits_disk += 1
                metrics.inc("plancache_get_total", result="hit_disk")
                return ent
        self.stats.misses += 1
        metrics.inc("plancache_get_total", result="miss")
        return None

    def put(self, key: str, payload: Dict[str, Any],
            meta: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        if not self.enabled:
            self.stats.bypassed += 1
            metrics.inc("plancache_put_total", result="bypass")
            return None
        ent = {"key": key, "schema": keying.SCHEMA_VERSION,
               "created": time.time(),
               "sum": keying.digest_of(payload),
               "meta": meta or {}, "payload": payload}
        self._remember(key, ent)
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            # pid-unique temp name: concurrent same-key writers must not
            # truncate each other's in-flight file before the atomic rename
            tmp = self.root / f"{key}.{os.getpid()}.tmp"
            tmp.write_text(json.dumps(ent))
            os.replace(tmp, self._path(key))
            self._index_add(key, ent["meta"])
        except OSError:
            self._meta = None        # disk tier is best-effort; rescan later
        self.stats.puts += 1
        metrics.inc("plancache_put_total", result="stored")
        return ent

    def _index_add(self, key: str, meta: Dict[str, Any]) -> None:
        """Keep the nearest() index incremental across our own puts — a full
        directory rescan per miss/put cycle would be quadratic in warm runs.
        The mtime stamp is refreshed so the next _meta_index() call doesn't
        discard the update (other processes' writes still trigger a rescan
        on their own mtime bumps after our next put)."""
        if self._meta is None:
            return
        self._meta = [(k, m) for k, m in self._meta if k != key]
        self._meta.append((key, meta))
        try:
            self._meta_mtime = self.root.stat().st_mtime_ns
        except OSError:
            self._meta = None

    def _read(self, key: str) -> Optional[Dict[str, Any]]:
        """Stat-free entry read (internal: nearest() must not count as a
        cache lookup)."""
        ent = self._mem.get(key)
        if ent is not None:
            return ent
        path = self._path(key)
        if not path.is_file():
            return None
        try:
            ent = json.loads(path.read_text())
        except json.JSONDecodeError:
            self.quarantine(key, "decode")
            return None
        except OSError:
            metrics.inc("plancache_io_errors_total", op="read")
            return None
        if ent.get("schema") != keying.SCHEMA_VERSION:
            return None
        if not self._checksum_ok(ent):
            self.quarantine(key, "checksum")
            return None
        return ent

    def _remember(self, key: str, ent: Dict[str, Any]) -> None:
        self._mem[key] = ent
        self._mem.move_to_end(key)
        while len(self._mem) > self.mem_capacity:
            self._mem.popitem(last=False)

    def clear_memory(self) -> None:
        """Drop the in-memory tier (tests use this to emulate a fresh
        process against a warm disk cache)."""
        self._mem.clear()

    def note_warm_start(self) -> None:
        self.stats.warm_starts += 1
        metrics.inc("plancache_warm_starts_total")

    # ----------------------------------------------------------- scanning
    def entries(self) -> Iterator[Dict[str, Any]]:
        """Iterate all on-disk entries (full JSON, including payload)."""
        if not self.root.is_dir():
            return
        for path in sorted(self.root.glob("*.json")):
            if path.name == STATS_FILE:
                continue
            try:
                yield json.loads(path.read_text())
            except json.JSONDecodeError:
                # self-healing: the corrupt file moves out of the cache dir
                # on first encounter, so scans don't re-count it forever
                self._mem.pop(path.stem, None)
                self._quarantine_path(path, "decode")
                continue
            except OSError:
                metrics.inc("plancache_io_errors_total", op="scan")
                continue

    def n_entries(self) -> int:
        if not self.root.is_dir():
            return 0
        return sum(1 for p in self.root.glob("*.json")
                   if p.name != STATS_FILE)

    def _meta_index(self) -> List[Tuple[str, Dict[str, Any]]]:
        """(key, meta) pairs for all disk entries, cached against the cache
        directory's mtime so repeated nearest() scans on misses don't
        re-parse every payload (entries hold full serialized PlanResults)."""
        try:
            mtime = self.root.stat().st_mtime_ns
        except OSError:
            return []
        if self._meta is None or self._meta_mtime != mtime:
            self._meta = [(ent.get("key", ""), ent.get("meta", {}))
                          for ent in self.entries()]
            self._meta_mtime = mtime
        return self._meta

    def nearest(self, template: str, hw: str,
                shape: Sequence[int]) -> Optional[Dict[str, Any]]:
        """The warm-start neighbor: the entry of the same kernel template on
        the same hardware whose shape vector is closest in log-space."""
        if not self.enabled:
            return None
        ranked = self._ranked_neighbors(template, hw, shape)
        return self._read(ranked[0][1]) if ranked else None

    def nearest_k(self, template: str, hw: str, shape: Sequence[int],
                  k: int = 3) -> List[Dict[str, Any]]:
        """The ``k`` closest same-template/same-hw entries, nearest first.
        Deterministic: ties in log-distance break on the entry key.  The
        plan service's shape-family rung walks this list so one corrupt or
        uncertifiable neighbor doesn't exhaust the rung."""
        if not self.enabled:
            return []
        out: List[Dict[str, Any]] = []
        for _, key in self._ranked_neighbors(template, hw, shape)[:max(0, k)]:
            ent = self._read(key)
            if ent is not None:
                out.append(ent)
        return out

    def _ranked_neighbors(self, template: str, hw: str,
                          shape: Sequence[int]) -> List[Tuple[float, str]]:
        shape = [max(1, int(s)) for s in shape]
        ranked: List[Tuple[float, str]] = []
        for key, meta in self._meta_index():
            if not key:
                continue             # unreadable/legacy entry: no key to load
            if meta.get("template") != template or meta.get("hw") != hw:
                continue
            cand = meta.get("shape")
            if not isinstance(cand, list) or len(cand) != len(shape):
                continue
            try:
                d = _log_distance(shape, cand)
            except (TypeError, ValueError):
                continue
            ranked.append((d, key))
        ranked.sort()
        return ranked

    # ----------------------------------------------------------- pruning
    def prune(self, *, max_entries: Optional[int] = None,
              max_age_s: Optional[float] = None) -> int:
        """Eviction policy for the disk tier: drop entries older than
        ``max_age_s``, entries with a stale schema, and (oldest-first) any
        beyond ``max_entries``.  Returns the number removed."""
        if not self.root.is_dir():
            return 0
        now = time.time()
        keep: List[Tuple[float, Path]] = []
        removed = 0
        for path in self.root.glob("*.json"):
            if path.name == STATS_FILE:
                continue
            try:
                ent = json.loads(path.read_text())
                created = float(ent.get("created", 0.0))
                stale = ent.get("schema") != keying.SCHEMA_VERSION
            except (json.JSONDecodeError, OSError, ValueError):
                created, stale = 0.0, True
            if stale or (max_age_s is not None and now - created > max_age_s):
                path.unlink(missing_ok=True)
                removed += 1
            else:
                keep.append((created, path))
        if max_entries is not None and len(keep) > max_entries:
            keep.sort()              # oldest first
            for _, path in keep[:len(keep) - max_entries]:
                path.unlink(missing_ok=True)
                removed += 1
        self.clear_memory()
        return removed

    # ----------------------------------------------------------- stats
    def flush_stats(self) -> Dict[str, int]:
        """Merge this process's counters into the on-disk cumulative stats
        (idempotent: only the delta since the last flush is added).  The
        read-modify-write runs under an advisory file lock so concurrent
        processes don't lose each other's deltas.  A disabled store never
        touches disk."""
        if not self.enabled:
            return self.cumulative_stats()
        snapshot = self.stats.as_dict()
        delta = {k: v - getattr(self._flushed, k)
                 for k, v in snapshot.items()}
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            with open(self.root / (STATS_FILE + ".lock"), "w") as lock:
                try:
                    import fcntl
                    fcntl.flock(lock, fcntl.LOCK_EX)
                except (ImportError, OSError):
                    pass             # non-POSIX: best-effort, unlocked
                cum = self.cumulative_stats()
                for k, v in delta.items():
                    cum[k] = cum.get(k, 0) + v
                tmp = self.root / f"{STATS_FILE}.{os.getpid()}.tmp"
                tmp.write_text(json.dumps(cum))
                os.replace(tmp, self.root / STATS_FILE)
            # only after the persist lands: a failed write keeps the delta
            # pending so a later flush retries it
            self._flushed = CacheStats(**snapshot)
        except OSError:
            # counted, not silent: the delta stays pending for a retry and
            # the miss shows up in metrics instead of vanishing
            metrics.inc("plancache_io_errors_total", op="stats_flush")
            cum = self.cumulative_stats()
            for k, v in delta.items():
                cum[k] = cum.get(k, 0) + v
        return cum

    def cumulative_stats(self) -> Dict[str, int]:
        path = self.root / STATS_FILE
        if path.is_file():
            try:
                return {k: int(v) for k, v in
                        json.loads(path.read_text()).items()}
            except (json.JSONDecodeError, ValueError):
                # a torn stats file resets the cumulative counters; move it
                # aside so the next flush starts a clean one
                self._quarantine_path(path, "stats_decode")
                return {}
            except OSError:
                metrics.inc("plancache_io_errors_total", op="stats_read")
                return {}
        return {}


@contextlib.contextmanager
def lookup_source(store: PlanCacheStore):
    """Label whether the planning done inside the block resolved from the
    registry.  Yields a dict whose ``source`` key reads ``"cache"`` after
    the block iff a lookup hit landed and nothing new was planned (a
    genuine hit raises ``hits`` without a corresponding ``put``)."""
    probe = {"source": "search"}
    hits0, puts0 = store.stats.hits, store.stats.puts
    yield probe
    if store.stats.hits > hits0 and store.stats.puts == puts0:
        probe["source"] = "cache"


def _log_distance(a: Sequence[int], b: Sequence[int]) -> float:
    import math
    d = 0.0
    for x, y in zip(a, b):
        x, y = max(1, int(x)), max(1, int(y))
        d += abs(math.log2(x / y))
    return d


# --------------------------------------------------------------- singleton
_STORE: Optional[PlanCacheStore] = None


def get_store() -> PlanCacheStore:
    """Process-wide store singleton.  Re-resolved when the cache directory
    or toggle env vars change (so tests can redirect it per-tmpdir)."""
    global _STORE
    root = default_cache_dir()
    enabled = cache_enabled()
    if _STORE is None or _STORE.root != root or _STORE.enabled != enabled:
        _STORE = PlanCacheStore(root, enabled=enabled)
    return _STORE


def reset_store() -> None:
    global _STORE
    _STORE = None


def stats_blob(store: Optional[PlanCacheStore] = None) -> Dict[str, Any]:
    """One JSON-ready view of the registry's state: root, entry counts by
    template, cumulative cross-process hit/miss counters and the derived
    hit rate.  Shared by ``python -m repro_torch.plancache stats --json`` and
    the ``launch/serve.py --introspect-port`` ``/plans`` endpoint."""
    store = store or get_store()
    cum = store.cumulative_stats()
    by_template: Dict[str, int] = {}
    for ent in store.entries():
        t = ent.get("meta", {}).get("template", "?")
        by_template[t] = by_template.get(t, 0) + 1
    hits = cum.get("hits_mem", 0) + cum.get("hits_disk", 0)
    total = hits + cum.get("misses", 0)
    return {
        "root": str(store.root), "enabled": store.enabled,
        "entries": store.n_entries(), "by_template": by_template,
        "cumulative": cum, "hit_rate": (hits / total if total else 0.0),
    }
