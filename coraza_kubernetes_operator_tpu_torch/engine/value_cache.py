"""Cross-batch value-hit cache: matcher outputs memoized by value bytes.

Real traffic repeats values ACROSS batches, not just within one — Host /
User-Agent / Accept headers, header names, hot paths — while the round-3
value dedup only collapsed repeats inside a single batch. This cache
carries matcher results (the per-row group-hit bit row) across batches:
a row whose exact (partition mask, value bytes, length, host-variant
bytes) key was evaluated before skips the matcher entirely; only misses
are scanned, and their hit rows are read back (bit-packed) to populate
the cache.

Soundness: a matcher row's output depends only on the key's contents —
device transforms are deterministic functions of the value, host-variant
bytes are part of the key, and the kind-partition mask (which decides
which matcher blocks were scanned, hence which hit columns are live) is
the key's prefix. Two rows with identical keys are indistinguishable to
``match_tier``.

Honest accounting (VERDICT r4: the round-3 dedup inflated req/s until
its factor was reported): ``stats()`` exposes hits/misses/evictions and
the hit rate — every benchmark that serves with this cache must report
them alongside throughput.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


class ValueHitCache:
    """LRU cache: key bytes -> bit-packed group-hit row (np.uint8[PB]).

    Bounded by total bytes (keys + rows), not entries: keys embed the
    full value bytes, so a body-width row costs KBs while a header row
    costs tens of bytes. Thread-safe (the sidecar's bulk fast path runs
    in HTTP handler threads concurrently with the batcher thread)."""

    def __init__(self, packed_len: int, max_bytes: int = 256 * 2**20):
        self.packed_len = packed_len
        self.max_bytes = max_bytes
        self._map: OrderedDict[bytes, np.ndarray] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def lookup(self, keys: list[bytes]):
        """Returns (found: dict key-index -> packed row, miss_indexes)."""
        found: dict[int, np.ndarray] = {}
        miss: list[int] = []
        with self._lock:
            for i, k in enumerate(keys):
                row = self._map.get(k)
                if row is None:
                    miss.append(i)
                else:
                    self._map.move_to_end(k)
                    found[i] = row
            self.hits += len(found)
            self.misses += len(miss)
        return found, miss

    def insert(self, keys: list[bytes], packed_rows: np.ndarray) -> None:
        """packed_rows [len(keys), packed_len] uint8."""
        if not keys:
            return
        with self._lock:
            for k, row in zip(keys, packed_rows):
                if k in self._map:
                    self._map.move_to_end(k)
                    continue
                self._map[k] = np.array(row, dtype=np.uint8)
                self._bytes += len(k) + self.packed_len + 64  # dict overhead est.
            while self._bytes > self.max_bytes and self._map:
                k, _ = self._map.popitem(last=False)
                self._bytes -= len(k) + self.packed_len + 64
                self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._map),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hits / total, 4) if total else None,
            }
