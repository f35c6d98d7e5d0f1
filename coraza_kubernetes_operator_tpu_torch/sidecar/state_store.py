"""Durable serving state: crash-safe snapshot of what the sidecar serves.

The reference data plane is stateless — a restarted WASM filter re-polls
the versioned rule cache and is serving again in one fetch. Our sidecar
carries minutes of hard-won state in memory instead: the compiled serving
ruleset, the last-known-good engine ring behind ``POST /waf/v1/rollback``,
and the rollout latches that stop a failed candidate from re-staging
every poll. A pod restart (or a SIGKILL) used to throw all of it away and
leave the replica blind until the cache poll AND the compile pipeline
completed — and with the cache unreachable, blind forever.

This module persists that state under ``CKO_STATE_DIR`` (docs/RECOVERY.md):

- **What**: per tenant — serving uuid + ruleset text, the LKG ring's
  (uuid, text) entries, rollout latches, and the analysis-rejected uuid.
  Ruleset *text* is the durable form: engines and device arrays are
  derived state, recompiled on restore through the shared engine factory
  (content-hash dedupe) and the persistent XLA compile cache, so a warm
  restore costs one text compile with near-zero XLA time.
- **When**: on every promote/swap/rollback (the reloader's ``on_persist``
  hook) and once more during graceful shutdown. A crash between swaps
  loses at most the swap in flight — never a served ruleset.
- **How**: atomically — write to a temp file in the same directory,
  ``fsync`` the file, ``os.replace`` over the target, ``fsync`` the
  directory. A torn write can only ever leave the PREVIOUS snapshot.
- **Load**: corruption-tolerant. Missing file, truncated JSON, garbage
  bytes, checksum mismatch, unknown schema — every failure degrades to
  ``None`` (clean cold start); a snapshot must never be able to crash or
  wedge boot.

The snapshot is versioned (``schema``) and checksummed (sha256 over the
canonical state JSON) so a partially flushed or bit-rotted file is
detected rather than half-applied.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

from ..utils import get_logger

log = get_logger("sidecar.state_store")

STATE_DIR_ENV = "CKO_STATE_DIR"
SNAPSHOT_NAME = "serving_state.json"
SCHEMA_VERSION = 1


def _canonical(state: dict) -> bytes:
    """Deterministic encoding the checksum is computed over."""
    return json.dumps(state, sort_keys=True, separators=(",", ":")).encode("utf-8")


class StateStore:
    """Atomic, versioned, corruption-tolerant snapshot file.

    ``state_dir`` of ``None``/empty reads ``CKO_STATE_DIR``; still empty
    disables the store entirely (every call is a cheap no-op) — tests and
    standalone runs pay nothing for durability they did not ask for.
    """

    def __init__(self, state_dir: str | None = None):
        if state_dir is None:
            state_dir = os.environ.get(STATE_DIR_ENV, "")
        self.state_dir = state_dir or None
        self._lock = threading.Lock()
        self.saves = 0
        self.save_failures = 0
        self.loads = 0
        self.load_rejected = 0

    @property
    def enabled(self) -> bool:
        return self.state_dir is not None

    @property
    def path(self) -> str | None:
        if self.state_dir is None:
            return None
        return os.path.join(self.state_dir, SNAPSHOT_NAME)

    # -- save ----------------------------------------------------------------

    def save(self, state: dict) -> bool:
        """Persist one snapshot atomically. Returns True on success; every
        failure (read-only dir, full disk, ...) is swallowed and counted —
        durability is best-effort and must never break serving."""
        if self.state_dir is None:
            return False
        payload = {
            "schema": SCHEMA_VERSION,
            "saved_at": time.time(),
            "checksum": hashlib.sha256(_canonical(state)).hexdigest(),
            "state": state,
        }
        try:
            with self._lock:
                self._write_atomic(json.dumps(payload, indent=1).encode("utf-8"))
            self.saves += 1
            return True
        except Exception as err:
            self.save_failures += 1
            log.error("state snapshot save failed", err, dir=self.state_dir)
            return False

    def _write_atomic(self, data: bytes) -> None:
        os.makedirs(self.state_dir, exist_ok=True)
        target = self.path
        tmp = f"{target}.tmp-{os.getpid()}"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, target)
        # Durability of the rename itself: fsync the directory so the new
        # dirent survives a power cut (rename alone only orders data).
        try:
            dfd = os.open(self.state_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # e.g. platforms refusing O_RDONLY on a directory

    # -- load ----------------------------------------------------------------

    def load(self) -> dict | None:
        """Read the snapshot back. ANY defect — missing, torn, truncated,
        garbage, checksum/schema mismatch — returns None (cold start);
        this path must never raise."""
        if self.state_dir is None:
            return None
        self.loads += 1
        try:
            with open(self.path, "rb") as f:
                payload = json.loads(f.read().decode("utf-8"))
            if not isinstance(payload, dict):
                raise ValueError("snapshot payload is not an object")
            if payload.get("schema") != SCHEMA_VERSION:
                raise ValueError(f"unknown snapshot schema {payload.get('schema')!r}")
            state = payload.get("state")
            if not isinstance(state, dict):
                raise ValueError("snapshot state is not an object")
            digest = hashlib.sha256(_canonical(state)).hexdigest()
            if digest != payload.get("checksum"):
                raise ValueError("snapshot checksum mismatch")
            return state
        except FileNotFoundError:
            return None
        except Exception as err:
            self.load_rejected += 1
            log.error(
                "state snapshot rejected; cold start", err, path=self.path
            )
            return None

    def stats(self) -> dict:
        return {
            "enabled": self.enabled,
            "dir": self.state_dir,
            "saves": self.saves,
            "save_failures": self.save_failures,
            "loads": self.loads,
            "load_rejected": self.load_rejected,
        }
