"""Thread-safe versioned ruleset cache.

Semantics mirror the reference ``internal/rulesets/cache/cache.go``:
per-instance append-only entry lists ordered oldest→newest with a ``latest``
UUID pointer; ``put`` mints a fresh UUID + timestamp; age- and size-based
pruning NEVER evicts an instance's latest entry (``cache.go:153-231``) so a
data plane can always fetch a complete ruleset.
"""

from __future__ import annotations

import threading
import uuid as uuid_mod
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone


@dataclass
class RuleSetEntry:
    uuid: str
    timestamp: datetime
    rules: str

    def to_json(self) -> dict:
        return {
            "uuid": self.uuid,
            "timestamp": format_timestamp(self.timestamp),
            "rules": self.rules,
        }


def format_timestamp(ts: datetime) -> str:
    """RFC3339 with sub-second precision and Z suffix (Go's RFC3339Nano)."""
    return ts.astimezone(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"


@dataclass
class RuleSetEntries:
    """Entries for one instance, oldest to newest; ``latest`` marks the
    current version's UUID."""

    latest: str = ""
    entries: list[RuleSetEntry] = field(default_factory=list)


class RuleSetCache:
    """Thread-safe storage for rulesets with versioning."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._entries: dict[str, RuleSetEntries] = {}

    def get(self, instance: str) -> RuleSetEntry | None:
        """The latest entry for ``instance`` (None if absent)."""
        with self._lock:
            bucket = self._entries.get(instance)
            if not bucket or not bucket.entries:
                return None
            for entry in bucket.entries:
                if entry.uuid == bucket.latest:
                    return entry
            return None

    def put(self, instance: str, rules: str) -> RuleSetEntry:
        """Store ``rules`` under a fresh UUID, appended newest-last."""
        with self._lock:
            entry = RuleSetEntry(
                uuid=str(uuid_mod.uuid4()),
                timestamp=datetime.now(timezone.utc),
                rules=rules,
            )
            bucket = self._entries.get(instance)
            if bucket is None:
                self._entries[instance] = RuleSetEntries(
                    latest=entry.uuid, entries=[entry]
                )
            else:
                bucket.entries.append(entry)
                bucket.latest = entry.uuid
            return entry

    def list_keys(self) -> list[str]:
        with self._lock:
            return list(self._entries.keys())

    def total_size(self) -> int:
        """Total bytes of cached rules across all entries."""
        with self._lock:
            return sum(
                len(e.rules)
                for bucket in self._entries.values()
                for e in bucket.entries
            )

    def count_entries(self, instance: str) -> int:
        with self._lock:
            bucket = self._entries.get(instance)
            return len(bucket.entries) if bucket else 0

    def set_entry_timestamp(
        self, instance: str, index: int, timestamp: datetime
    ) -> None:
        """Test hook: fake an entry's age instead of sleeping (the reference
        exposes the same for its prune tests, ``cache.go:126-136``)."""
        with self._lock:
            bucket = self._entries.get(instance)
            if bucket and 0 <= index < len(bucket.entries):
                bucket.entries[index].timestamp = timestamp

    def prune(self, max_age: timedelta) -> int:
        """Remove entries older than ``max_age``; never the latest."""
        with self._lock:
            pruned = 0
            now = datetime.now(timezone.utc)
            for bucket in self._entries.values():
                kept: list[RuleSetEntry] = []
                for entry in bucket.entries:
                    if entry.uuid == bucket.latest:
                        kept.append(entry)  # never prune latest
                    elif now - entry.timestamp <= max_age:
                        kept.append(entry)
                    else:
                        pruned += 1
                bucket.entries = kept
            return pruned

    def prune_by_size(self, max_size: int) -> int:
        """Remove oldest entries until total size ≤ ``max_size``; never an
        instance's latest entry."""
        with self._lock:
            current = sum(
                len(e.rules)
                for bucket in self._entries.values()
                for e in bucket.entries
            )
            if current <= max_size:
                return 0
            pruned = 0
            for bucket in self._entries.values():
                if current <= max_size:
                    break
                kept: list[RuleSetEntry] = []
                for entry in bucket.entries:
                    if entry.uuid == bucket.latest:
                        kept.append(entry)
                    elif current > max_size:
                        current -= len(entry.rules)
                        pruned += 1
                    else:
                        kept.append(entry)
                bucket.entries = kept
            return pruned
