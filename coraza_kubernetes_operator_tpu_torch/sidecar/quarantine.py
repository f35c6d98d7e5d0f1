"""Poison-request quarantine: per-request fault isolation for the
batched device path.

Batched evaluation means batch-sized blast radius: one request that
faults device eval fails its whole window, and a repeat offender
arriving every few windows keeps the circuit breaker open and the fleet
in host fallback indefinitely — a single adversarial request demotes
the entire data plane. This module shrinks the blast radius back to the
offending request:

- :class:`QuarantineRegistry` — a bounded-TTL set of request
  *fingerprints* (normalized method/path/header/body hash). The batcher
  consults it at batch-assembly time and routes matching requests
  straight to the host fallback, so the device path stays promoted and
  the poison never reaches a device window again.
- :class:`PoisonBisector` — a background worker that, when a window
  faults, re-dispatches budgeted sub-windows (binary split) to isolate
  the offender(s). Only requests that fault *alone* are quarantined,
  and isolation is only trusted when the device demonstrably works on
  OTHER traffic in the same job (a clean sub-window succeeded, or a
  canary control dispatch does) — a device that fails everything is a
  sick device, not a poison storm, and the original error is escalated
  to the breaker via ``on_unisolated`` instead.

The registry is the per-request host-confirmation escape channel the
approximate-prefilter and scored-anomaly designs (ROADMAP items 3/4)
route their rare-case traffic through: "send THIS request to the host,
keep the batch on device".

Knobs (env, read at construction):

- ``CKO_QUARANTINE_MAX`` (default 1024): max fingerprints held; the
  oldest entry is evicted first.
- ``CKO_QUARANTINE_TTL_S`` (default 300): entry lifetime — quarantine
  is a circuit for *repeat* offenders, not a permanent blocklist.
- ``CKO_QUARANTINE_BISECT_BUDGET`` (default 16): max sub-window
  re-dispatches per bisection job.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time

from ..engine.request import HttpRequest
from ..utils import get_logger

log = get_logger("sidecar.quarantine")

DEFAULT_MAX_ENTRIES = 1024
DEFAULT_TTL_S = 300.0
DEFAULT_BISECT_BUDGET = 16
# Wall budget per bisection job: sub-dispatches ride the live engine, so
# a pathological job must not monopolize it for long.
DEFAULT_BISECT_WALL_S = 10.0


def fingerprint(req: HttpRequest) -> str:
    """Stable fingerprint of a request's evaluation-relevant content.

    Normalized so the same poison payload re-sent matches: method is
    case-folded, header names are lowercased and the header list sorted
    (order and casing don't change a verdict's inputs in a way an
    attacker controls usefully; sorting makes re-sends canonical), the
    URI and body go in verbatim. ``remote_addr`` is deliberately
    excluded — the same poison from a second source IP must still match.
    """
    h = hashlib.sha256()
    h.update(req.method.upper().encode("latin-1", "replace"))
    h.update(b"\x00")
    h.update(req.uri.encode("latin-1", "replace"))
    h.update(b"\x00")
    for name, value in sorted(
        (n.lower(), v) for n, v in req.headers
    ):
        h.update(name.encode("latin-1", "replace"))
        h.update(b"\x01")
        h.update(value.encode("latin-1", "replace"))
        h.update(b"\x02")
    h.update(b"\x00")
    h.update(req.body)
    return h.hexdigest()


class QuarantineRegistry:
    """Bounded-TTL fingerprint set with hit accounting. Thread-safe;
    ``match`` is on the batch-assembly path, so the empty-registry case
    must stay a couple of attribute reads (the batcher additionally
    gates on ``len(registry)`` before fingerprinting anything)."""

    def __init__(
        self,
        max_entries: int | None = None,
        ttl_s: float | None = None,
    ):
        import os

        if max_entries is None:
            max_entries = int(os.environ.get("CKO_QUARANTINE_MAX", "") or DEFAULT_MAX_ENTRIES)
        if ttl_s is None:
            ttl_s = float(os.environ.get("CKO_QUARANTINE_TTL_S", "") or DEFAULT_TTL_S)
        self.max_entries = max(1, int(max_entries))
        self.ttl_s = max(0.0, float(ttl_s))
        self._lock = threading.Lock()
        # fp -> expiry (monotonic); insertion order doubles as eviction
        # order (dicts preserve it, and re-adds re-insert).
        self._entries: dict[str, float] = {}
        self.hits_total = 0
        self.isolated_total = 0
        self.flushes = 0
        # Quarantine/verdict-cache interop (sidecar/verdict_cache.py):
        # a fingerprint quarantined AFTER its verdict was cached must
        # not keep serving the cached allow. The sidecar wires this to
        # ``VerdictCache.evict_fingerprint``; fired on every add.
        self.on_add = None  # (fp,) -> None

    def _notify_add(self, fp: str) -> None:
        hook = self.on_add
        if hook is None:
            return
        try:
            hook(fp)
        except Exception as err:  # interop must never block isolation
            log.error("quarantine on_add hook failed", err)

    def __len__(self) -> int:
        with self._lock:
            self._expire_locked()
            return len(self._entries)

    def _expire_locked(self) -> None:
        now = time.monotonic()
        dead = [fp for fp, exp in self._entries.items() if exp <= now]
        for fp in dead:
            del self._entries[fp]

    def add(self, fp: str) -> None:
        """Quarantine a fingerprint (refreshes TTL on re-add)."""
        with self._lock:
            self._expire_locked()
            self._entries.pop(fp, None)
            while len(self._entries) >= self.max_entries:
                oldest = next(iter(self._entries))
                del self._entries[oldest]
            self._entries[fp] = time.monotonic() + self.ttl_s
            self.isolated_total += 1
        self._notify_add(fp)

    def match(self, req: HttpRequest, span=None) -> bool:
        """True when the request is quarantined (counts a hit).

        ``span`` is an optional flight-recorder context
        (observability/tracing.py); a hit stamps the matched fingerprint
        onto it, so an exported trace identifies WHICH quarantine entry
        diverted the request off the device path."""
        with self._lock:
            if not self._entries:
                return False
        fp = fingerprint(req)
        with self._lock:
            exp = self._entries.get(fp)
            if exp is None:
                return False
            if exp <= time.monotonic():
                del self._entries[fp]
                return False
            self.hits_total += 1
        if span is not None:
            now = time.monotonic()
            span.event(
                "quarantine_match",
                now,
                now,
                track="degraded",
                args={"fingerprint": fp[:16]},
            )
        return True

    def flush(self) -> int:
        """Drop every entry; returns how many were held."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.flushes += 1
            return n

    def stats(self) -> dict:
        with self._lock:
            self._expire_locked()
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "ttl_s": self.ttl_s,
                "hits_total": self.hits_total,
                "isolated_total": self.isolated_total,
                "flushes": self.flushes,
            }


class _BisectJob:
    __slots__ = ("engine", "error", "requests")

    def __init__(self, engine, error, requests):
        self.engine = engine
        self.error = error
        self.requests = requests


class PoisonBisector:
    """Background offender isolation for faulted windows.

    ``submit(engine, err, requests)`` enqueues a bisection job and
    returns True; False (queue full / stopped) means no isolation will
    be attempted — a wedged bisector degrades gracefully to
    pre-quarantine behavior.

    The caller (the sidecar's window-fault hook) feeds the breaker
    *provisionally* at fault time — prompt demotion under a real device
    storm is non-negotiable — and the bisector FORGIVES that failure via
    ``on_isolated`` when it proves the fault was a poison request on a
    healthy device, so an isolated offender never walks the breaker
    toward open.

    Per job: budgeted binary-split re-dispatch of sub-windows on the
    faulting engine. A sub-window that *succeeds* proves its members
    clean AND the device healthy; a singleton that *fails* is an
    offender. Offenders are quarantined only when the job saw at least
    one success — otherwise one canary control dispatch
    (``degraded._canary_request``) arbitrates: canary success → the
    device is fine, quarantine the offenders (covers singleton windows
    with no clean sibling); canary failure → the device is sick, no
    forgiveness (the provisional breaker failure stands). Jobs that
    isolate nothing also stand unforgiven, and ``on_unisolated`` (if
    wired) is told about the original error.
    """

    def __init__(
        self,
        registry: QuarantineRegistry,
        on_isolated=None,
        on_unisolated=None,
        budget: int | None = None,
        wall_s: float = DEFAULT_BISECT_WALL_S,
        queue_size: int = 8,
    ):
        import os

        if budget is None:
            budget = int(
                os.environ.get("CKO_QUARANTINE_BISECT_BUDGET", "")
                or DEFAULT_BISECT_BUDGET
            )
        self.registry = registry
        self.on_isolated = on_isolated  # () -> None: forgive the failure
        self.on_unisolated = on_unisolated  # (err) -> None
        self.budget = max(1, int(budget))
        self.wall_s = max(0.1, float(wall_s))
        self._queue: queue.Queue[_BisectJob | None] = queue.Queue(
            maxsize=max(1, int(queue_size))
        )
        self._thread: threading.Thread | None = None
        self._running = False
        self.jobs_total = 0
        self.jobs_dropped = 0

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(
            target=self._run, name="cko-quarantine-bisect", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        t = self._thread
        if t is not None:
            t.join(timeout=self.wall_s + 5.0)

    def submit(self, engine, error, requests) -> bool:
        """Enqueue a faulted window for isolation. False → the caller
        owns classification (feed the breaker)."""
        if not self._running or engine is None or not requests:
            return False
        try:
            self._queue.put_nowait(_BisectJob(engine, error, list(requests)))
        except queue.Full:
            self.jobs_dropped += 1
            return False
        return True

    # -- worker ---------------------------------------------------------------

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                if not self._running:
                    return
                continue
            try:
                self._bisect(job)
            except Exception as err:
                log.error("bisection job failed", err)
                self._escalate(job.error)

    def _sub_eval(self, engine, requests) -> None:
        """One sub-window re-dispatch on the faulting engine; raises on
        device fault. Uses the same two-stage path the batcher does so
        the fault fires identically."""
        if hasattr(engine, "prepare"):
            engine.collect(engine.prepare(requests))
        else:
            engine.evaluate(requests)

    def _escalate(self, error) -> None:
        if self.on_unisolated is None:
            return
        try:
            self.on_unisolated(error)
        except Exception as err:
            log.error("on_unisolated hook failed", err)

    def _bisect(self, job: _BisectJob) -> None:
        self.jobs_total += 1
        deadline = time.monotonic() + self.wall_s
        budget = self.budget
        stack: list[list[HttpRequest]] = [job.requests]
        offenders: list[HttpRequest] = []
        saw_success = False
        exhausted = False
        while stack:
            if budget <= 0 or time.monotonic() >= deadline:
                exhausted = True
                break
            subset = stack.pop()
            budget -= 1
            try:
                self._sub_eval(job.engine, subset)
                saw_success = True
                continue
            except Exception:
                pass
            if len(subset) == 1:
                offenders.append(subset[0])
            else:
                mid = len(subset) // 2
                stack.append(subset[mid:])
                stack.append(subset[:mid])
        if offenders and not saw_success and budget > 0:
            # Every sub-dispatch faulted: either everything is poison or
            # the device itself is sick. One control dispatch of the
            # canonical canary arbitrates.
            from .degraded import _canary_request

            try:
                self._sub_eval(job.engine, [_canary_request()])
                saw_success = True
            except Exception:
                pass
        if offenders and saw_success:
            for req in offenders:
                self.registry.add(fingerprint(req))
            log.critical(
                "poison request(s) quarantined — device path stays promoted",
                offenders=len(offenders),
                window=len(job.requests),
                entries=len(self.registry),
                residual=exhausted,
            )
            if self.on_isolated is not None:
                try:
                    self.on_isolated()
                except Exception as err:
                    log.error("on_isolated hook failed", err)
            return
        # Nothing isolatable (transient fault, sick device, or budget
        # exhausted before any singleton): the provisional breaker
        # failure stands.
        self._escalate(job.error)
