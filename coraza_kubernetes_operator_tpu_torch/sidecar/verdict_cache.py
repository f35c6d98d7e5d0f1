"""Fingerprint verdict cache: the repeat-traffic fast path's first level.

At fleet scale most WAF traffic is near-duplicate — the same probe, the
same health check, the same hot API call, byte for byte. Every repeat
still pays a full batch-assembly → device round trip today. This module
remembers the verdict the engine already produced for a request's
normalized fingerprint (``quarantine.fingerprint``: method/uri/sorted
headers/body — ``remote_addr`` excluded) and serves the repeat at
batch-assembly time, before the row ever reaches ``WafEngine.prepare``.

Keys are ``(tenant, ruleset_uuid, fingerprint)``: a verdict is only
valid for the exact compiled ruleset that produced it, so entries from
a previous ruleset can never answer for a new one even before the
wholesale invalidation lands. The sidecar additionally calls
``invalidate_all()`` on EVERY engine swap (reload, rollout promotion,
forced rollback, warm restore) — the uuid key component is defense in
depth, not the primary correctness mechanism.

Never consulted for quarantine-matched rows (quarantine wins — the
batcher checks the registry first), deadline-header requests, or
trusted-tenant requests (both ride the Python object path with
``no_cache``/tenant markers). A fingerprint quarantined AFTER its
verdict was cached is evicted via ``evict_fingerprint`` — a cached
allow must not outlive its quarantine.

Knobs (env, read at construction):

- ``CKO_VERDICT_CACHE_MAX`` (default 8192): max entries held (LRU
  eviction). ``0`` disables the cache entirely — the batcher then skips
  fingerprinting and the hot path is byte-for-byte the pre-cache one.
- ``CKO_VERDICT_CACHE_TTL_S`` (default 300): entry lifetime. Like the
  quarantine registry, the cache is a circuit for *repeat* traffic, not
  a permanent memo — a bounded TTL caps how long any anomaly (however
  unlikely, given wholesale swap invalidation) can persist.
"""

from __future__ import annotations

import copy
import threading
import time
from collections import OrderedDict

from ..utils import get_logger

log = get_logger("sidecar.verdict_cache")

DEFAULT_MAX_ENTRIES = 8192
DEFAULT_TTL_S = 300.0


class VerdictCache:
    """Bounded LRU+TTL map from ``(tenant, ruleset_uuid, fingerprint)``
    to a frozen verdict record. Thread-safe; ``lookup`` is on the
    batch-assembly path, so the disabled case must stay one attribute
    read (the batcher gates on ``enabled`` before fingerprinting)."""

    def __init__(
        self,
        max_entries: int | None = None,
        ttl_s: float | None = None,
    ):
        import os

        if max_entries is None:
            raw = os.environ.get("CKO_VERDICT_CACHE_MAX", "")
            max_entries = int(raw) if raw != "" else DEFAULT_MAX_ENTRIES
        if ttl_s is None:
            ttl_s = float(
                os.environ.get("CKO_VERDICT_CACHE_TTL_S", "") or DEFAULT_TTL_S
            )
        self.max_entries = max(0, int(max_entries))
        self.enabled = self.max_entries > 0
        self.ttl_s = max(0.0, float(ttl_s))
        self._lock = threading.Lock()
        # key -> (expiry, frozen verdict); LRU order via move_to_end on
        # hit, TTL checked lazily at lookup (plus a sweep in stats()).
        self._entries: OrderedDict[tuple, tuple[float, object]] = OrderedDict()
        self.hits_total = 0
        self.misses_total = 0
        self.evictions_total = 0
        # Entries dropped by correctness events: ruleset swaps
        # (invalidate_all), quarantine additions (evict_fingerprint),
        # and operator flushes — NOT capacity evictions or TTL expiry.
        self.invalidations_total = 0
        self.flushes = 0

    def __len__(self) -> int:
        with self._lock:
            self._expire_locked()
            return len(self._entries)

    def _expire_locked(self) -> None:
        now = time.monotonic()
        dead = [k for k, (exp, _v) in self._entries.items() if exp <= now]
        for k in dead:
            del self._entries[k]

    def lookup(self, tenant, ruleset_uuid, fp: str):
        """The frozen verdict for this key, or None (counts a miss).
        A hit refreshes LRU recency but never the TTL — a verdict's
        lifetime is bounded from insertion, no matter how hot it is."""
        if not self.enabled:
            return None
        key = (tenant, ruleset_uuid, fp)
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses_total += 1
                return None
            exp, verdict = entry
            if exp <= now:
                del self._entries[key]
                self.misses_total += 1
                return None
            self._entries.move_to_end(key)
            self.hits_total += 1
            return verdict

    def insert(self, tenant, ruleset_uuid, fp: str, verdict) -> None:
        """Freeze and remember a device-produced verdict. The stored
        record is a deep copy — hits hand the SAME frozen object to
        every requester, so nothing downstream may see a mutation of
        the original (reply functions treat verdicts as read-only)."""
        if not self.enabled:
            return
        frozen = copy.deepcopy(verdict)
        key = (tenant, ruleset_uuid, fp)
        with self._lock:
            self._entries.pop(key, None)
            while len(self._entries) >= self.max_entries:
                self._entries.popitem(last=False)
                self.evictions_total += 1
            self._entries[key] = (time.monotonic() + self.ttl_s, frozen)

    def invalidate_all(self) -> int:
        """Wholesale invalidation (every ruleset swap lands here via the
        sidecar's on_swap hook); returns how many entries dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.invalidations_total += n
            return n

    def evict_fingerprint(self, fp: str) -> int:
        """Drop every entry for one fingerprint across all tenant/uuid
        keys (quarantine interop: a cached allow must not keep serving
        after the fingerprint is quarantined). O(entries) scan — only
        runs when the bisector isolates an offender, never on the hot
        path."""
        with self._lock:
            dead = [k for k in self._entries if k[2] == fp]
            for k in dead:
                del self._entries[k]
            self.invalidations_total += len(dead)
            return len(dead)

    def flush(self) -> int:
        """Operator escape hatch (POST /waf/v1/cache/flush): drop every
        entry; returns how many were held."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.invalidations_total += n
            self.flushes += 1
            return n

    def stats(self) -> dict:
        with self._lock:
            self._expire_locked()
            lookups = self.hits_total + self.misses_total
            return {
                "enabled": self.enabled,
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "ttl_s": self.ttl_s,
                "hits_total": self.hits_total,
                "misses_total": self.misses_total,
                "hit_rate": (self.hits_total / lookups) if lookups else 0.0,
                "evictions_total": self.evictions_total,
                "invalidations_total": self.invalidations_total,
                "flushes": self.flushes,
            }
