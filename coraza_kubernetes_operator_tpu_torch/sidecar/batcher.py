"""Micro-batching scheduler: amortize device steps over in-flight requests.

Requests arriving within one batching window are evaluated in a single
device step. The window closes on whichever comes first: ``max_batch_size``
requests buffered, ``max_batch_delay_ms`` elapsed since the first request
of the window (the cap on the added wait), or its lane having no window in
flight — group commit: a lane with nothing dispatched takes what its queue
holds and goes at once, and a busy lane batches behind its in-flight
window until the collector hands that window's slot back.

The reference has no analog (Envoy evaluates per request inside the WASM
module); batching is the accelerator-shaped redesign: the device wants
thousands of rows per step, and the pipelined dispatch overlaps the next
window's host assembly with the current device step.

**Pipelined dispatch (double buffering).** The loop is split into two
stages riding ``WafEngine.prepare`` / ``WafEngine.collect``
(docs/PIPELINE.md): the dispatch thread assembles window N+1 and enqueues
its device step while window N's executable is still running on device;
a dedicated collector thread drains in-flight windows in STRICT dispatch
order (FIFO — verdicts are never reordered) and resolves their futures.
In-flight depth is bounded (``CKO_PIPELINE_DEPTH``, default 2 — classic
double buffering). Under the idle-lane close rule a lane overlaps two
windows only when one reaches its size or delay cap while the other is in
flight (overload); otherwise the next window closes as the previous one is
collected. The bound keeps the existing backpressure path: when
the device falls behind, windows queue in the submit queue, ``pending()``
grows, and the server's admission control sheds with 429.

**Priority lanes (overload isolation).** Submissions are classified into
two independent micro-batch streams: the *interactive* lane (headers-only
requests — the gateway fast path where ext_proc answers on end-of-stream)
and the *bulk* lane (bodied requests). Each lane owns its submit queue,
dispatch thread, batching delay, and in-flight depth gate, so a bodied
flood saturating the bulk lane's pipeline slots can never queue ahead of
headers-only windows. Verdict order stays strictly FIFO *per lane* (one
collector drains a shared in-flight queue; each lane's records enter it
in dispatch order).

**Weighted-fair admission.** Each lane's submit queue is a deficit-
round-robin ``_FairQueue`` over per-tenant buckets: at batch-assembly
time tenants are served in proportion to their configured weights
(``CKO_TENANT_WEIGHTS``, default equal), so one noisy tenant cannot
monopolize window slots even before admission control starts shedding.

**Window log.** Every window the dispatch stage closes gets a record on
the process's window log (``observability/tracing.py::WINDOWS``): the
sums of its requests' waits (for an ext_proc worker, and from ``submit``
to the window's close), the engine's measured stage spans, the card's
per-stage device intervals, and the time its futures resolved. The
collector commits it; a traced request's pipeline spans are copied from it.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

from ..engine.request import HttpRequest
from ..engine.waf import Verdict, WafEngine
from ..observability.tracing import WINDOWS, WindowRecord
from ..utils import get_logger
from .quarantine import fingerprint

log = get_logger("sidecar.batcher")

DEFAULT_MAX_BATCH_SIZE = 2048
DEFAULT_MAX_BATCH_DELAY_MS = 1.0
# Bounded in-flight window depth (double buffering). Depth 1 degenerates
# to the synchronous alternate-host-and-device loop; depth 2 overlaps one
# assembling window with one executing window; deeper helps only when
# host assembly is much faster than the device step AND arrival bursts
# outpace both.
DEFAULT_PIPELINE_DEPTH = 2

# Priority lanes: interactive = headers-only (no body to tensorize — the
# ext_proc answer-on-eos fast path), bulk = bodied. Lane identity is a
# property of the REQUEST, not the frontend, so every frontend classifies
# the same way and verdicts cannot depend on the transport.
LANE_INTERACTIVE = "interactive"
LANE_BULK = "bulk"
LANES = (LANE_INTERACTIVE, LANE_BULK)


# Why a window closed (``WindowRecord.close``, ``BatcherStats.closes``):
# its lane had nothing in flight, its delay passed (or stop() cut it
# short), it held ``max_batch_size`` requests, or it is a pre-assembled
# blob window (or a per-request window a queued blob window closed, to
# keep FIFO order).
CLOSE_IDLE, CLOSE_DELAY, CLOSE_SIZE, CLOSE_BLOB = "idle", "delay", "size", "blob"
CLOSE_REASONS = (CLOSE_IDLE, CLOSE_DELAY, CLOSE_SIZE, CLOSE_BLOB)


# A readback wait that wakes more than this late found the process itself
# stalled (a thread holding the interpreter in native code, a paused
# process); the window deadline does not charge that time to the device.
_STALL_TICK_S = 0.25


def _wait_running(done: threading.Event, budget: float) -> bool:
    """Wait for ``done`` up to ``budget`` seconds in which this process
    ran. The wait goes in ticks; a tick that wakes more than a tick late
    extends the budget by its lateness, so a stall of the whole process,
    in which neither the readback nor this wait could run, is not counted
    against the device. A device that hangs while the process runs meets
    the deadline on time."""
    end = time.monotonic() + budget
    while True:
        t = time.monotonic()
        step = min(_STALL_TICK_S, end - t)
        if step <= 0:
            return done.is_set()
        if done.wait(timeout=step):
            return True
        late = time.monotonic() - t - step
        if late > _STALL_TICK_S:
            end += late


def classify_lane(request) -> str:
    """Lane for one request: bodied → bulk, headers-only → interactive."""
    return LANE_BULK if getattr(request, "body", b"") else LANE_INTERACTIVE


class _DepthGate:
    """Counting semaphore with a LIVE-adjustable limit. The adaptive
    scheduler retunes pipeline depth on a running batcher; a plain
    ``threading.Semaphore`` cannot shrink, so the gate tracks held slots
    against a mutable limit under one condition variable. Shrinking
    never revokes held slots — the pipeline just stops admitting new
    windows until enough in-flight ones collect."""

    def __init__(self, limit: int) -> None:
        self._cv = threading.Condition()
        self._limit = max(1, int(limit))
        self._held = 0

    @property
    def limit(self) -> int:
        with self._cv:
            return self._limit

    def set_limit(self, limit: int) -> None:
        with self._cv:
            self._limit = max(1, int(limit))
            self._cv.notify_all()

    def acquire(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._held >= self._limit:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
            self._held += 1
            return True

    def release(self) -> None:
        with self._cv:
            if self._held > 0:
                self._held -= 1
            self._cv.notify()

    def idle(self) -> bool:
        """True while no slot is held: the lane has nothing in flight."""
        with self._cv:
            return self._held == 0


class _FairQueue:
    """Deficit-round-robin tenant-fair submit queue, shaped like the
    ``queue.Queue`` subset the dispatch loop uses (``put`` /
    ``get(timeout=)`` / ``get_nowait`` / ``qsize``, raising
    ``queue.Empty``).

    Items are the batcher's queue entries: ``(request, tenant, fut,
    span)`` triples (cost 1, bucketed by tenant), pre-assembled
    ``_BlobWindow`` windows (cost 1 — one already-packed unit, bucketed
    under the default tenant), and ``None`` shutdown sentinels (a
    control channel with absolute priority so stop() is never stuck
    behind a backlog).

    DRR: each active tenant bucket holds a deficit counter; serving one
    item costs 1, a visited bucket that cannot pay earns
    ``quantum * weight(tenant)`` and the rotation moves on. A bucket
    leaving the rotation (emptied) forfeits its deficit — the standard
    reset that stops idle tenants from banking credit. With one active
    tenant (the common case) every get() is O(1) and order is FIFO."""

    def __init__(self, weight_fn=None, quantum: float = 8.0) -> None:
        self._cv = threading.Condition()
        self._control: deque = deque()
        self._buckets: dict[str | None, deque] = {}
        self._rotation: deque = deque()
        self._deficit: dict[str | None, float] = {}
        self._size = 0
        # True while the rotation head has not yet earned its quantum
        # for the current visit: a bucket earns exactly once per visit,
        # spends the deficit down, then the rotation moves on.
        self._fresh = True
        # weight_fn(tenant) -> float; the sidecar wires the governor's
        # CKO_TENANT_WEIGHTS table. Unset/failing → equal weights.
        self.weight_fn = weight_fn
        self.quantum = float(quantum)

    @staticmethod
    def _tenant_of(item) -> str | None:
        if isinstance(item, _BlobWindow):
            return None
        return item[1]

    def put(self, item) -> None:
        with self._cv:
            if item is None:
                self._control.append(item)
            else:
                key = self._tenant_of(item)
                bucket = self._buckets.get(key)
                if bucket is None:
                    bucket = self._buckets[key] = deque()
                    self._rotation.append(key)
                    self._deficit[key] = 0.0
                bucket.append(item)
                self._size += 1
            self._cv.notify()

    def get(self, timeout: float | None = None, until=None):
        """``until()``, when given, ends an empty wait early (raising
        ``queue.Empty``); whoever makes it true calls ``wake()``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if self._control:
                    return self._control.popleft()
                if self._size > 0:
                    return self._pop_locked()
                if until is not None and until():
                    raise queue.Empty
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._cv.wait(remaining)

    def get_nowait(self):
        with self._cv:
            if self._control:
                return self._control.popleft()
            if self._size > 0:
                return self._pop_locked()
            raise queue.Empty

    def wake(self) -> None:
        """Wake a ``get`` waiting on its ``until`` predicate."""
        with self._cv:
            self._cv.notify_all()

    def qsize(self) -> int:
        with self._cv:
            return self._size + len(self._control)

    def tenant_backlog(self) -> dict:
        """Queued-item count per tenant bucket (stats + tenant-scoped
        admission control)."""
        with self._cv:
            return {k: len(b) for k, b in self._buckets.items()}

    def _weight(self, key) -> float:
        w = 1.0
        if self.weight_fn is not None:
            try:
                w = float(self.weight_fn(key))
            except Exception:  # a broken weight table must not stall serving
                w = 1.0
        # Weight 0/negative would never earn deficit and starve forever;
        # clamp to a tiny positive share instead (shed belongs to
        # admission control, not the queue).
        return w if w > 0.0 else 1e-3

    def _pop_locked(self):
        while True:
            key = self._rotation[0]
            bucket = self._buckets[key]
            if self._fresh:
                # Earn once per visit; unspent deficit carries across
                # visits so sub-1 weighted quanta still add up.
                self._deficit[key] += self.quantum * self._weight(key)
                self._fresh = False
            if self._deficit[key] < 1.0:
                self._rotation.rotate(-1)
                self._fresh = True
                continue
            item = bucket.popleft()
            self._deficit[key] -= 1.0
            self._size -= 1
            if not bucket:
                del self._buckets[key]
                del self._deficit[key]
                self._rotation.popleft()
                self._fresh = True
            return item


def _nearest_rank(sorted_samples: list[float], p: float) -> float:
    """Nearest-rank percentile: the ceil(p*n)-th smallest sample. The old
    ``int(len * p)`` indexing over-read by one whenever p*n landed on an
    integer (p50 of 4 samples returned the 3rd; p99 of 100 returned the
    max instead of the 99th)."""
    if not sorted_samples:
        return 0.0
    idx = max(0, math.ceil(p * len(sorted_samples)) - 1)
    return sorted_samples[min(len(sorted_samples) - 1, idx)]


@dataclass
class BatcherStats:
    """Counters exposed on the sidecar /stats endpoint."""

    batches: int = 0
    requests: int = 0
    errors: int = 0
    batch_sizes: list[int] = field(default_factory=list)
    step_latencies_s: list[float] = field(default_factory=list)
    # Pipelined stage samples per window group: host assemble (tensorize +
    # tier + dispatch enqueue) and, on the card, the stages' event-measured
    # device time.
    host_stage_s: list[float] = field(default_factory=list)
    device_stage_s: list[float] = field(default_factory=list)
    # Dispatched windows by why they closed (CLOSE_REASONS).
    closes: dict[str, int] = field(default_factory=lambda: dict.fromkeys(CLOSE_REASONS, 0))
    on_batch: object = None  # optional (size, latency_s, trace_id) hook for metrics
    on_stage: object = None  # optional (host_s, device_s, trace_id) hook for metrics
    _max_samples: int = 4096

    def record(self, size: int, latency_s: float, trace_id: str | None = None) -> None:
        self.batches += 1
        self.requests += size
        if len(self.batch_sizes) >= self._max_samples:
            del self.batch_sizes[: self._max_samples // 2]
            del self.step_latencies_s[: self._max_samples // 2]
        self.batch_sizes.append(size)
        self.step_latencies_s.append(latency_s)
        if self.on_batch is not None:
            self.on_batch(size, latency_s, trace_id)  # type: ignore[operator]

    def record_stage(
        self, host_s: float, device_s: float | None, trace_id: str | None = None
    ) -> None:
        """``device_s``: the window's event-measured device seconds, None
        off the card (then only the host sample is kept)."""
        for samples, value in ((self.host_stage_s, host_s), (self.device_stage_s, device_s)):
            if value is None:
                continue
            if len(samples) >= self._max_samples:
                del samples[: self._max_samples // 2]
            samples.append(value)
        if self.on_stage is not None:
            self.on_stage(host_s, device_s, trace_id)  # type: ignore[operator]

    def snapshot(self) -> dict:
        lats = sorted(self.step_latencies_s)
        hosts = sorted(self.host_stage_s)
        devs = sorted(self.device_stage_s)
        return {
            "batches": self.batches,
            "requests": self.requests,
            "errors": self.errors,
            "mean_batch_size": (
                sum(self.batch_sizes) / len(self.batch_sizes) if self.batch_sizes else 0.0
            ),
            "p50_step_ms": _nearest_rank(lats, 0.50) * 1e3,
            "p99_step_ms": _nearest_rank(lats, 0.99) * 1e3,
            "p50_host_stage_ms": _nearest_rank(hosts, 0.50) * 1e3,
            "p99_host_stage_ms": _nearest_rank(hosts, 0.99) * 1e3,
            "p50_device_stage_ms": _nearest_rank(devs, 0.50) * 1e3,
            "p99_device_stage_ms": _nearest_rank(devs, 0.99) * 1e3,
            "closes": dict(self.closes),
        }


@dataclass
class _Group:
    """One engine's share of a dispatched window."""

    engine: WafEngine | None
    idxs: list[int]
    t_dispatch: float
    inflight: object = None  # InFlightBatch (pipelined path)
    verdicts: list[Verdict] | None = None  # sync path (phase_split / stubs)
    error: BaseException | None = None
    # Quarantined group (sidecar/quarantine.py): its requests matched the
    # poison registry at assembly time and are answered by host fallback
    # in the collect stage — never dispatched to device, never feeding
    # the breaker or device stats.
    quarantined: bool = False
    # Materialized requests, kept only where a later stage needs them
    # (quarantined groups; blob split groups for fault classification).
    reqs: list | None = None
    # Verdict-cache fast path (sidecar/verdict_cache.py). ``cached``
    # marks a group whose verdicts were answered from the cache at
    # assembly time — never dispatched to device, no breaker traffic,
    # no device stats, no shadow mirror. On DEVICE groups, ``fps``
    # carries the fingerprints of cache-eligible rows (window idx ->
    # fp) for insertion at collect, ``dups`` the in-window duplicate
    # scatter map (unique idx -> duplicate idxs answered by the same
    # verdict), and ``cache_uuid`` pins the compiled-ruleset identity
    # the cache keys on, resolved at dispatch time.
    cached: bool = False
    fps: dict | None = None
    dups: dict | None = None
    cache_uuid: object = None


@dataclass
class _BlobWindow:
    """A pre-assembled ingest window (sidecar/ingest.py): request bytes
    already packed in the ``native.serialize_requests`` wire format.
    Rides the same submit queue, depth semaphore, FIFO in-flight queue,
    breaker hooks, and stats as per-request windows — but dispatches as
    ONE ``engine.prepare_blob`` call, so the hot path never materializes
    per-request Python objects. The future resolves to the window's
    ``list[Verdict]`` (or the group error)."""

    # bytes OR the ingest frontend's handed-off bytearray — either way it
    # reaches the native tensorizer zero-copy via the buffer protocol.
    blob: bytes | bytearray
    n_req: int
    fut: Future
    # Flight-recorder contexts (observability/tracing.py), aligned with
    # the blob's request index space; None (the steady state) or a list
    # whose entries are SpanContext/None. Untraced windows pay one
    # attribute read in the collect stage.
    spans: list | None = None
    # Priority lane the assembling frontend classified this window into
    # (per-lane accounting must survive the queue round-trip).
    lane: str = LANE_BULK
    # submit_window's time: the start of the window's batcher wait.
    t_submit: float = 0.0


@dataclass
class _WindowRecord:
    # list of (req, tenant, fut, span, no_cache, t_submit, extproc_wait_s)
    # items, or a _BlobWindow
    window: object
    groups: list
    # Dispatch-stage entry time (after assembly + the depth-semaphore
    # backpressure wait): the boundary between a traced request's
    # "queue" and "assemble" spans.
    t_win: float = 0.0
    # Blob window split by quarantine routing: groups carry idxs into the
    # blob's request index space and the collect stage stitches verdicts
    # back into one list for the window future.
    split: bool = False
    # Lane that dispatched this window: the collector releases the SAME
    # lane's depth slot.
    lane: str = LANE_BULK
    # The window's record on the window log, committed by the collector.
    log: WindowRecord | None = None
    # Why the window closed (CLOSE_REASONS).
    close: str = CLOSE_BLOB


@dataclass
class _ReadbackJob:
    """One deadline-supervised device readback, handed to the disposable
    readback worker. ``lock`` serializes the completion/abandon race:
    the worker publishes results and sets ``done`` under it; the
    collector re-checks ``done`` under it before abandoning."""

    engine: object
    inflight: object
    lock: threading.Lock = field(default_factory=threading.Lock)
    done: threading.Event = field(default_factory=threading.Event)
    abandoned: bool = False
    verdicts: list | None = None
    error: BaseException | None = None


class MicroBatcher:
    """Submit requests; background threads form, dispatch, and collect
    batch windows.

    ``engine_fn`` is called at the top of every window so an atomic engine
    swap (hot reload) takes effect on the NEXT window without pausing the
    loop; windows already in flight pin the engine that dispatched them
    and drain to completion on it — a reload never drops or re-evaluates
    an in-flight verdict. A ``None`` engine fails every request in the
    window with ``EngineUnavailable`` — the server maps that through the
    failure policy.
    """

    def __init__(
        self,
        engine_fn,
        max_batch_size: int = DEFAULT_MAX_BATCH_SIZE,
        max_batch_delay_ms: float = DEFAULT_MAX_BATCH_DELAY_MS,
        phase_split: bool = False,
        pipeline_depth: int | None = None,
        lane_delay_ms: float | None = None,
        weight_fn=None,
    ):
        # phase_split: evaluate phase-1 (headers) before body ingest —
        # early denials never tensorize their bodies (SURVEY §3.4). The
        # phased path has no prepare/collect split (two dependent device
        # passes), so its windows evaluate synchronously in the dispatch
        # stage and ride the in-flight queue only for FIFO ordering.
        self.phase_split = phase_split
        # engine_fn(tenant) -> WafEngine | None. Single-tenant callers may
        # pass a zero-arg callable; it is adapted below.
        import inspect

        if len(inspect.signature(engine_fn).parameters) == 0:
            self._engine_fn = lambda _tenant: engine_fn()
        else:
            self._engine_fn = engine_fn
        self.max_batch_size = max(1, int(max_batch_size))
        self.max_batch_delay_s = max(0.0, float(max_batch_delay_ms)) / 1e3
        if pipeline_depth is None:
            pipeline_depth = int(
                os.environ.get("CKO_PIPELINE_DEPTH", str(DEFAULT_PIPELINE_DEPTH))
            )
        self.pipeline_depth = max(1, int(pipeline_depth))
        # Per-lane batching delay: bulk inherits max_batch_delay_ms; the
        # interactive (headers-only) lane defaults to the SAME value so a
        # single-lane workload behaves exactly as before, and can be
        # tightened via lane_delay_ms / the adaptive scheduler. Read
        # fresh at every window open, so a live retune lands on the next
        # window without a restart.
        interactive_delay_s = (
            self.max_batch_delay_s
            if lane_delay_ms is None
            else max(0.0, float(lane_delay_ms)) / 1e3
        )
        self.lane_delay_s: dict[str, float] = {
            LANE_INTERACTIVE: interactive_delay_s,
            LANE_BULK: self.max_batch_delay_s,
        }
        # One DRR submit queue + dispatch thread + depth gate per lane.
        # The in-flight queue and collector stay SHARED: each lane's
        # records enter in its own dispatch order (per-lane FIFO verdict
        # order holds), and the single collector keeps the existing
        # resolve-order invariants without a second drain path.
        self._queues: dict[str, _FairQueue] = {
            lane: _FairQueue(weight_fn=weight_fn) for lane in LANES
        }
        self._inflight: queue.Queue[_WindowRecord | None] = queue.Queue()
        self._depth_gates: dict[str, _DepthGate] = {
            lane: _DepthGate(self.pipeline_depth) for lane in LANES
        }
        self._inflight_lock = threading.Lock()
        self._inflight_count = 0
        # Count of lanes currently assembling/dispatching a window (the
        # `busy` signal must cover both dispatch threads).
        self._windows_open = 0
        self._threads: dict[str, threading.Thread] = {}
        self._collector: threading.Thread | None = None
        self._running = False
        self.stats = BatcherStats()
        # Per-lane window/request counters (cko_lane_* gauges).
        self.lane_windows: dict[str, int] = {lane: 0 for lane in LANES}
        self.lane_requests: dict[str, int] = {lane: 0 for lane in LANES}
        # Degraded-mode hooks (sidecar/degraded.py): device evaluation
        # outcomes feed the circuit breaker. Missing-engine windows are
        # NOT device failures and bypass these.
        self.on_engine_error = None  # (engine, err) -> None
        self.on_engine_success = None  # (engine,) -> None
        # Shadow mirror (sidecar/rollout.py): every successfully collected
        # window group is offered as (engine, requests, verdicts,
        # serving_s) so a staged rollout candidate can replay the SAME
        # live traffic and compare verdicts. The hook must be cheap and
        # non-blocking (the rollout manager samples and drops on a full
        # queue); like the breaker hooks it is a side channel — a raising
        # hook never decides a verdict.
        self.on_window = None  # (engine, requests, verdicts, serving_s) -> None
        # Blob windows carry no request objects; materializing them just
        # to feed on_window would tax every hot-path window. When set,
        # window_wanted(engine) -> bool gates that materialization — the
        # sidecar wires it to "a rollout is actively shadowing this
        # engine", which is the only consumer.
        self.window_wanted = None  # (engine,) -> bool
        # Graceful-drain hook (docs/RECOVERY.md): at stop(), windows that
        # were accepted but never dispatched are EVALUATED through this —
        # (engine, requests) -> list[Verdict] — instead of failed. The
        # sidecar wires it to the degraded manager's host-fallback
        # evaluator, so a drain loses no verdict even when the device
        # path is already gone. Unset, the drain falls back to the
        # engine's own host evaluator; with no engine at all, items still
        # fail with EngineUnavailable as before.
        self.drain_evaluate = None
        # Wall budget for evaluating those leftovers (the sidecar sizes
        # it from CKO_DRAIN_BUDGET_S); items past the deadline fail.
        self.drain_budget_s = 5.0
        self.drained_requests = 0
        self.drain_failed = 0
        self._drain_deadline_t: float | None = None
        # Per-request wait budget for evaluate(); the sidecar resolves it
        # config field -> CKO_REQUEST_TIMEOUT_S -> 30.0.
        self.request_timeout_s = 30.0
        # Dispatch watchdog (per-window device deadline). None = auto
        # (~10x warm p99 once the engine is warmed AND enough latency
        # samples exist); <= 0 disables; an explicit positive value is
        # still gated on engine.warmed (a cold XLA compile legitimately
        # takes minutes). A blown deadline ABANDONS the window: its
        # futures fail with WindowAbandoned (the server's rescue paths
        # re-answer them from host fallback — real verdicts, zero lost),
        # the stuck readback parks on a disposable worker, and the
        # collector FIFO keeps moving.
        self.window_deadline_s: float | None = None
        self.windows_abandoned = 0
        self.parked_readbacks = 0
        # Auto-deadline gate: below this many latency samples the p99 is
        # too noisy to trust as a deadline baseline.
        self._deadline_min_samples = 20
        self._readback_q: queue.Queue[_ReadbackJob | None] | None = None
        self._readback_thread: threading.Thread | None = None
        # Poison quarantine (sidecar/quarantine.py): a registry with
        # match(req) consulted at batch-assembly time; matching requests
        # are answered by fallback_evaluate(engine, requests) instead of
        # riding a device window. on_window_fault(engine, err,
        # requests_fn) supersedes on_engine_error for device-window
        # faults when set — the sidecar routes loss-class errors to the
        # device-loss manager and the rest to the bisector/breaker.
        self.quarantine = None
        self.fallback_evaluate = None  # (engine, requests) -> list[Verdict]
        self.on_window_fault = None  # (engine, err, requests_fn|None) -> None
        # Verdict cache (sidecar/verdict_cache.py): consulted at
        # batch-assembly time — AFTER the quarantine check (quarantine
        # wins), and never for trusted-tenant or ``no_cache`` (deadline-
        # header) rows. Hits resolve their futures during dispatch;
        # misses are deduped in-window (identical fingerprints ride the
        # device once, verdicts scattered to every requester at collect)
        # and inserted when their device verdicts land.
        # cache_key_fn(engine) -> ruleset uuid names the compiled
        # ruleset in the cache key; unset, id(engine) stands in (the
        # sidecar's wholesale invalidation on swap guards staleness).
        self.verdict_cache = None
        self.cache_key_fn = None  # (engine,) -> ruleset uuid
        # Duplicate rows served by in-window scatter instead of a device
        # slot (the cko_window_dedup_rows_total metric).
        self.window_dedup_rows = 0
        # Collector-leak visibility: stop() flips this when the collect
        # thread outlives its join budget instead of leaking silently.
        self.collector_wedged = False
        self._collector_join_s = 30.0
        # Requests inside queued-but-not-dispatched blob windows; the
        # admission-control signal must count them (a blob window is one
        # queue item but n_req requests of backlog). Per lane.
        self._blob_pending: dict[str, int] = {lane: 0 for lane in LANES}
        # Bytes of those queued blob windows — the ingress byte ledger
        # (sidecar.governor) reports them so assembled-but-undispatched
        # windows are visible in the memory-backpressure picture.
        self._blob_pending_bytes: dict[str, int] = {lane: 0 for lane in LANES}

    @property
    def busy(self) -> bool:
        """True while a window is being assembled/dispatched or any
        window is in flight on device. Lets waiters distinguish "stuck"
        from "a (re)compile or big step is in flight" and extend their
        timeout instead of failing mid-compile."""
        with self._inflight_lock:
            return self._windows_open > 0 or self._inflight_count > 0

    # -- adaptive knobs (sidecar/scheduler.py) -------------------------------

    def set_lane_delay(self, lane: str, delay_ms: float) -> None:
        """Retune one lane's batching delay; takes effect on the next
        window that lane opens."""
        self.lane_delay_s[lane] = max(0.0, float(delay_ms)) / 1e3

    def set_pipeline_depth(self, depth: int) -> None:
        """Retune the bounded in-flight depth for BOTH lanes. Shrinking
        never revokes in-flight windows — admission of new ones waits."""
        self.pipeline_depth = max(1, int(depth))
        for gate in self._depth_gates.values():
            gate.set_limit(self.pipeline_depth)

    def inflight_windows(self) -> int:
        """Windows dispatched but not yet collected (the
        ``cko_inflight_windows`` gauge)."""
        with self._inflight_lock:
            return self._inflight_count

    def start(self) -> None:
        self._running = True
        for lane in LANES:
            t = threading.Thread(
                target=self._run, args=(lane,), name=f"batcher-{lane}", daemon=True
            )
            self._threads[lane] = t
            t.start()
        self._collector = threading.Thread(
            target=self._collect_loop, name="batcher-collect", daemon=True
        )
        self._collector.start()

    def stop(self) -> None:
        """Drain deterministically: the dispatch thread exits, every
        window already in flight is COLLECTED (its futures resolve with
        real verdicts), then still-queued submissions fail fast.

        The collector's shutdown sentinel must land AFTER the dispatch
        thread's last window. If the dispatch thread outlives the
        bounded join here (e.g. mid-prepare in a minutes-long cold
        compile), a watchdog waits it out and enqueues the sentinel
        then — stop() stays bounded, and the straggler window still
        collects (in the background) instead of abandoning its futures
        behind an early sentinel."""
        # One wall deadline for the whole drain: queued windows are
        # evaluated (host fallback) until it passes, then fail fast.
        self._drain_deadline_t = time.monotonic() + max(0.0, self.drain_budget_s)
        self._running = False
        for lane in LANES:
            self._queues[lane].put(None)
        threads = [t for t in self._threads.values() if t is not None]
        for t in threads:
            t.join(timeout=5)
        stragglers = [t for t in threads if t.is_alive()]
        if stragglers:
            def _sentinel_after_dispatch():
                for t in stragglers:
                    t.join()
                self._inflight.put(None)

            threading.Thread(
                target=_sentinel_after_dispatch,
                name="batcher-drain",
                daemon=True,
            ).start()
        else:
            self._inflight.put(None)
        if self._collector:
            self._collector.join(timeout=self._collector_join_s)
            if self._collector.is_alive():
                # A wedged collector means some window's readback never
                # returned and its depth slot is gone for good. Flag it
                # loudly — a silent leak here previously survived stop()
                # unnoticed.
                self.collector_wedged = True
                log.critical(
                    "collector thread still alive past the stop budget — "
                    "a device readback is wedged; its futures will not "
                    "resolve",
                    join_budget_s=self._collector_join_s,
                    inflight=self.inflight_windows(),
                )
        q = self._readback_q
        if q is not None:
            q.put(None)
        self._drain_pending()

    def _drain_pending(self) -> None:
        """Resolve any futures still queued at shutdown instead of
        abandoning them. Accepted windows are EVALUATED within the drain
        budget (host fallback when the device path is gone) — a graceful
        drain loses no verdict; only items past the deadline, or with no
        engine to answer them, fail with ``EngineUnavailable``."""
        for lane in LANES:
            q = self._queues[lane]
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                self._drain_item(item)

    # -- graceful drain (docs/RECOVERY.md) -----------------------------------

    def _drain_deadline(self) -> float:
        t = self._drain_deadline_t
        if t is None:
            t = time.monotonic() + max(0.0, self.drain_budget_s)
            self._drain_deadline_t = t
        return t

    def _drain_eval(self, requests, tenant=None):
        """Evaluate drained requests off the device path; None on any
        failure (the caller then fails the future the legacy way)."""
        if time.monotonic() >= self._drain_deadline():
            return None
        try:
            engine = self._engine_fn(tenant)
            if engine is None:
                return None
            if self.drain_evaluate is not None:
                verdicts = self.drain_evaluate(engine, requests)
            else:
                fallback = getattr(engine, "host_fallback", None)
                if fallback is not None:
                    verdicts = fallback.evaluate(requests)
                else:
                    verdicts = engine.evaluate(requests)
        except Exception as err:
            log.error("drain evaluation failed", err, batch=len(requests))
            return None
        return verdicts if len(verdicts) == len(requests) else None

    def _drain_item(self, item) -> None:
        """Resolve one still-queued submit-queue item at shutdown (owns
        the blob-backlog accounting for queue-popped items)."""
        if item is None:
            return
        if isinstance(item, _BlobWindow):
            with self._inflight_lock:
                self._blob_pending[item.lane] -= item.n_req
                self._blob_pending_bytes[item.lane] -= len(item.blob)
            self._drain_blob(item)
        else:
            self._drain_triple(item)

    def _drain_blob(self, bw: _BlobWindow) -> None:
        if bw.fut.cancelled():
            return
        verdicts = None
        try:
            from ..native import blob_requests

            reqs = blob_requests(bw.blob, bw.n_req)
        except Exception as err:
            log.error("drain blob materialization failed", err)
            reqs = None
        if reqs is not None:
            verdicts = self._drain_eval(reqs)
        if verdicts is not None:
            self.drained_requests += bw.n_req
            _resolve(bw.fut.set_result, list(verdicts))
        else:
            self.drain_failed += bw.n_req
            _resolve(bw.fut.set_exception, EngineUnavailable("batcher stopped"))

    def _drain_triple(self, item) -> None:
        req, tenant, fut, span = item[:4]
        if fut.cancelled():
            return
        if span is not None:
            span.annotate_path("drained")
        verdicts = self._drain_eval([req], tenant)
        if verdicts is not None:
            self.drained_requests += 1
            _resolve(fut.set_result, verdicts[0])
        else:
            self.drain_failed += 1
            _resolve(fut.set_exception, EngineUnavailable("batcher stopped"))

    def submit(
        self,
        request: HttpRequest,
        tenant: str | None = None,
        span=None,
        lane: str | None = None,
        no_cache: bool = False,
        extproc_wait_s: float = 0.0,
    ) -> Future:
        """Enqueue one request; the Future resolves to its Verdict.
        ``span`` is an optional flight-recorder SpanContext; the collect
        stage stamps the pipeline spans onto it before the future
        resolves. ``lane`` pins a priority lane; unset, the request is
        classified by body presence (bodied → bulk). ``no_cache`` keeps
        the row off the verdict cache entirely (the server marks
        deadline-header requests — their rescue/cancel dance must see
        the unmodified device path). ``extproc_wait_s`` is how long the
        request's messages waited for an ext_proc worker before this
        call; it and the submit time go to the window log."""
        fut: Future = Future()
        if lane is None:
            lane = classify_lane(request)
        self._queues[lane].put(
            (request, tenant, fut, span, no_cache, time.monotonic(), extproc_wait_s)
        )
        return fut

    def submit_window(
        self, blob: bytes | bytearray, n_req: int, spans=None,
        lane: str = LANE_BULK
    ) -> Future:
        """Enqueue a pre-assembled ingest window (request blob in the
        ``native.serialize_requests`` format). Dispatched as its own
        window — never coalesced with per-request submissions — on the
        default tenant's engine pinned at dispatch time (reload-safe
        draining, same as per-request windows). The Future resolves to
        the window's ``list[Verdict]``. ``spans`` optionally carries one
        flight-recorder context per blob request index (or None); the
        assembling frontend names the ``lane`` it already accumulates
        per-lane windows for."""
        fut: Future = Future()
        with self._inflight_lock:
            self._blob_pending[lane] += n_req
            self._blob_pending_bytes[lane] += len(blob)
        self._queues[lane].put(
            _BlobWindow(blob=blob, n_req=n_req, fut=fut, spans=spans, lane=lane,
                        t_submit=time.monotonic())
        )
        return fut

    def pending(self, lane: str | None = None) -> int:
        """Requests queued but not yet picked into a window (blob
        windows count their full request payload). ``lane`` scopes the
        signal to one priority lane; unset, both lanes sum — the global
        admission-control view."""
        lanes = LANES if lane is None else (lane,)
        with self._inflight_lock:
            blob_n = sum(self._blob_pending[ln] for ln in lanes)
        # qsize() also counts queued _BlobWindow items (1 each); their
        # requests are already in blob_n, so subtracting nothing keeps
        # the signal conservative (over-counts by the window count).
        return sum(self._queues[ln].qsize() for ln in lanes) + blob_n

    def pending_bytes(self) -> int:
        """Bytes of blob windows queued but not yet dispatched (the
        stats/ledger view of assembled-window memory)."""
        with self._inflight_lock:
            return sum(self._blob_pending_bytes.values())

    def tenant_pending(self, tenant: str | None) -> int:
        """Queued submissions attributed to one tenant across both
        lanes (tenant-scoped admission control; blob windows ride the
        default tenant's bucket)."""
        total = 0
        for q in self._queues.values():
            total += q.tenant_backlog().get(tenant, 0)
        return total

    def tenant_backlog(self) -> dict:
        """Merged per-tenant queued-item counts across lanes."""
        merged: dict = {}
        for q in self._queues.values():
            for k, v in q.tenant_backlog().items():
                merged[k] = merged.get(k, 0) + v
        return merged

    def evaluate(
        self,
        request: HttpRequest,
        timeout_s: float | None = None,
        tenant: str | None = None,
        span=None,
    ) -> Verdict:
        if timeout_s is None:
            timeout_s = self.request_timeout_s
        return self.submit(request, tenant=tenant, span=span).result(
            timeout=timeout_s
        )

    # -- dispatch stage ------------------------------------------------------

    def _run(self, lane: str = LANE_BULK) -> None:
        q = self._queues[lane]
        carry = None
        while self._running or carry is not None:
            item = carry if carry is not None else q.get()
            carry = None
            if item is None:
                continue
            if not self._running:
                # Shutdown drain: the accepted item still gets a verdict
                # (host fallback) within the drain budget.
                self._drain_item(item)
                continue
            with self._inflight_lock:
                self._windows_open += 1
            try:
                if isinstance(item, _BlobWindow):
                    # Pre-assembled window: dispatch as-is, never coalesce.
                    with self._inflight_lock:
                        self._blob_pending[lane] -= item.n_req
                        self._blob_pending_bytes[lane] -= len(item.blob)
                    self._dispatch_or_fail(item, lane, CLOSE_BLOB)
                    continue
                window: list[tuple[HttpRequest, str | None, Future]] = [item]
                # The lane delay is read at window open so a live retune
                # (adaptive scheduler) lands on the very next window.
                deadline = time.monotonic() + self.lane_delay_s[lane]
                gate = self._depth_gates[lane]
                close = CLOSE_SIZE
                while len(window) < self.max_batch_size:
                    # With nothing of the lane in flight there is nothing
                    # to batch behind: take what the queue holds and go.
                    # Otherwise fill until the delay, or until the
                    # collector frees the lane (it wakes this queue).
                    idle = gate.idle()
                    remaining = deadline - time.monotonic()
                    if not idle and remaining <= 0:
                        close = CLOSE_DELAY
                        break
                    try:
                        nxt = q.get_nowait() if idle else q.get(timeout=remaining, until=gate.idle)
                    except queue.Empty:
                        if idle:
                            close = CLOSE_IDLE
                            break
                        continue
                    if nxt is None:
                        close = CLOSE_DELAY
                        break
                    if isinstance(nxt, _BlobWindow):
                        # A blob window closes the assembling window; it
                        # dispatches on the next loop turn (FIFO kept).
                        carry = nxt
                        close = CLOSE_BLOB
                        break
                    window.append(nxt)
                self._dispatch_or_fail(window, lane, close)
            finally:
                with self._inflight_lock:
                    self._windows_open -= 1

    def _dispatch_or_fail(self, window, lane: str, close: str) -> None:
        """Acquire the lane's in-flight slot (bounded depth — THE
        backpressure point: while the device is ``pipeline_depth``
        windows behind, assembly blocks here, the submit queue grows,
        and admission control sheds). Depth gates are per lane, so a
        bulk flood holding its slots never blocks interactive
        dispatch. ``close`` is why the window closed (CLOSE_REASONS)."""
        gate = self._depth_gates[lane]
        while not gate.acquire(timeout=0.1):
            if not self._running:
                # Shutdown with the pipeline full: drain the assembled
                # window off-device instead of failing it. (Blob-backlog
                # accounting already ran when the item left the queue.)
                if isinstance(window, _BlobWindow):
                    self._drain_blob(window)
                else:
                    for triple in window:
                        self._drain_triple(triple)
                return
        with self._inflight_lock:
            self._inflight_count += 1
            self.lane_windows[lane] += 1
            self.lane_requests[lane] += (
                window.n_req if isinstance(window, _BlobWindow) else len(window)
            )
            self.stats.closes[close] += 1
        try:
            if isinstance(window, _BlobWindow):
                record = self._dispatch_blob(window)
            else:
                record = self._dispatch_window(window)
            record.lane = lane
            record.close = close
        except BaseException:
            # _dispatch_window is defensive per group; anything escaping
            # it must still release the slot or the pipeline deadlocks.
            with self._inflight_lock:
                self._inflight_count -= 1
            gate.release()
            raise
        try:
            record.log = _open_log(record)
        except Exception as err:  # the window log must never decide a verdict
            log.error("window log open failed", err)
        self._inflight.put(record)

    def _dispatch_window(
        self, window: list[tuple[HttpRequest, str | None, Future, object]]
    ) -> _WindowRecord:
        t_win = time.monotonic()
        # Group the window by the tenant's COMPILED MODEL, not by tenant
        # name: tenants typically fork a few base policies, so windows
        # touching many tenants still coalesce into one device step per
        # distinct model (the step count is what the accelerator feels —
        # BASELINE multi-tenant config serves 32 tenants over ~4 models).
        groups: dict[int, list[int]] = {}
        group_engine: dict[int, WafEngine] = {}
        missing: dict[str | None, list[int]] = {}
        quarantined: dict[int, list[int]] = {}
        # Quarantine gate: len() is cheap and the registry is empty in
        # the steady state, so the hot path pays one attribute read.
        registry = self.quarantine
        if registry is not None and not len(registry):
            registry = None
        # Verdict-cache gate: same shape — disabled costs one attribute
        # read and the window never fingerprints anything.
        vcache = self.verdict_cache
        if vcache is not None and not vcache.enabled:
            vcache = None
        # Per-engine fingerprint bookkeeping (cache-enabled windows
        # only): fps maps dispatched idx -> fingerprint (insert at
        # collect), dups maps a unique row to the duplicates riding it,
        # seen dedups fingerprints within this window.
        group_fps: dict[int, dict[int, str]] = {}
        group_dups: dict[int, dict[int, list[int]]] = {}
        group_seen: dict[int, dict[str, int]] = {}
        uuid_cache: dict[int, object] = {}
        dedup_rows = 0
        # engine_fn resolved once per DISTINCT tenant (it may take the
        # tenant-manager lock); memoizing also pins one engine per tenant
        # for the whole window even if a hot reload lands mid-grouping.
        tenant_cache: dict[str | None, WafEngine | None] = {}
        for idx, (_req, tenant, _fut, _span, _no_cache, *_waits) in enumerate(window):
            if _fut.cancelled():
                # Deadline-missed request already answered by the host
                # fallback — don't spend a device slot on it.
                continue
            if tenant not in tenant_cache:
                tenant_cache[tenant] = self._engine_fn(tenant)
            engine = tenant_cache[tenant]
            if engine is None:
                missing.setdefault(tenant, []).append(idx)
                continue
            key = id(engine)
            group_engine[key] = engine
            if registry is not None and registry.match(_req, span=_span):
                # Quarantined poison: answered by host fallback in the
                # collect stage — it never rides a device window again.
                quarantined.setdefault(key, []).append(idx)
                continue
            if vcache is not None and tenant is None and not _no_cache:
                # Cache-eligible row: quarantine already said no, the
                # default tenant serves it, and no deadline rides it.
                fp = fingerprint(_req)
                if key not in uuid_cache:
                    uuid_cache[key] = self._cache_uuid(engine)
                verdict = vcache.lookup(None, uuid_cache[key], fp)
                if verdict is not None:
                    # Fast path: answered at assembly time — the row
                    # never rides the device or waits on the FIFO.
                    self._trace_cached_span(_span)
                    _resolve(_fut.set_result, verdict)
                    continue
                seen = group_seen.setdefault(key, {})
                first = seen.get(fp)
                if first is not None:
                    # In-window duplicate: rides the first occurrence's
                    # device row; its verdict scatters at collect.
                    group_dups.setdefault(key, {}).setdefault(
                        first, []
                    ).append(idx)
                    dedup_rows += 1
                    continue
                seen[fp] = idx
                group_fps.setdefault(key, {})[idx] = fp
            groups.setdefault(key, []).append(idx)
        if dedup_rows:
            self.window_dedup_rows += dedup_rows
        out_groups: list[_Group] = []
        for key, idxs in quarantined.items():
            out_groups.append(
                _Group(
                    engine=group_engine[key],
                    idxs=idxs,
                    t_dispatch=time.monotonic(),
                    quarantined=True,
                    reqs=[window[i][0] for i in idxs],
                )
            )
        for tenant, idxs in missing.items():
            out_groups.append(
                _Group(
                    engine=None,
                    idxs=idxs,
                    t_dispatch=time.monotonic(),
                    error=EngineUnavailable(
                        f"no compiled ruleset loaded for tenant {tenant!r}"
                    ),
                )
            )
        for key, idxs in groups.items():
            engine = group_engine[key]
            g = _Group(
                engine=engine,
                idxs=idxs,
                t_dispatch=time.monotonic(),
                fps=group_fps.get(key),
                dups=group_dups.get(key),
                cache_uuid=uuid_cache.get(key),
            )
            reqs = [window[i][0] for i in idxs]
            try:
                if self.phase_split or not hasattr(engine, "prepare"):
                    # Synchronous group (phase-split or a stub engine
                    # without the two-stage API): evaluated here, riding
                    # the in-flight queue for FIFO resolution only.
                    if self.phase_split:
                        g.verdicts = engine.evaluate_phased(reqs)
                    else:
                        g.verdicts = engine.evaluate(reqs)
                else:
                    g.inflight = engine.prepare(reqs)
            except Exception as err:  # dispatch failure → per-request error
                g.error = err
            out_groups.append(g)
        return _WindowRecord(window=window, groups=out_groups, t_win=t_win)

    def _dispatch_blob(self, bw: _BlobWindow) -> _WindowRecord:
        """Dispatch a pre-assembled ingest window: one engine (default
        tenant, pinned here — a reload lands on the NEXT window), one
        ``prepare_blob`` call. Engines without the blob API (test stubs)
        materialize the requests and evaluate synchronously."""
        t_win = time.monotonic()
        engine = self._engine_fn(None)
        registry = self.quarantine
        if registry is not None and not len(registry):
            registry = None
        vcache = self.verdict_cache
        if vcache is not None and not vcache.enabled:
            vcache = None
        if engine is not None and (registry is not None or vcache is not None):
            try:
                record = self._dispatch_blob_split(bw, engine, registry, vcache)
            except Exception as err:
                # Materialization/probe failure: fall through to the
                # normal blob dispatch — quarantine routing and the
                # verdict cache are both best-effort.
                log.error("blob window assembly probe failed", err)
                record = None
            if record is not None:
                return record
        g = _Group(engine=engine, idxs=[], t_dispatch=time.monotonic())
        if engine is None:
            g.error = EngineUnavailable(
                "no compiled ruleset loaded for tenant None"
            )
        else:
            try:
                if not self.phase_split and hasattr(engine, "prepare_blob"):
                    g.inflight = engine.prepare_blob(bw.blob, bw.n_req)
                else:
                    from ..native import blob_requests

                    reqs = blob_requests(bw.blob, bw.n_req)
                    if self.phase_split:
                        g.verdicts = engine.evaluate_phased(reqs)
                    else:
                        g.verdicts = engine.evaluate(reqs)
            except Exception as err:
                g.error = err
        return _WindowRecord(window=bw, groups=[g], t_win=t_win)

    def _dispatch_blob_split(
        self, bw: _BlobWindow, engine, registry, vcache=None
    ) -> _WindowRecord | None:
        """Quarantine + verdict-cache routing for a blob window:
        materialize the requests, split quarantined rows (host fallback
        at collect), cache-hit rows (answered at assembly), and
        in-window duplicates (scattered at collect) from the unique
        remainder, which dispatches per-request (``engine.prepare``).
        Returns None when nothing matched and no cache is wired — the
        caller then runs the normal zero-copy blob dispatch. With the
        cache enabled but every row a unique miss, the zero-copy
        ``prepare_blob`` dispatch is kept and only the fingerprints ride
        along for insertion at collect."""
        from ..native import blob_requests

        reqs = blob_requests(bw.blob, bw.n_req)
        spans = bw.spans
        qidx = []
        if registry is not None:
            qidx = [
                i
                for i, r in enumerate(reqs)
                if registry.match(
                    r, span=spans[i] if spans and i < len(spans) else None
                )
            ]
        qset = set(qidx)
        cached_idx: list[int] = []
        cached_verdicts: list[Verdict] = []
        device_idx: list[int] = []
        fps: dict[int, str] = {}
        dups: dict[int, list[int]] = {}
        uuid = None
        if vcache is not None:
            uuid = self._cache_uuid(engine)
            seen: dict[str, int] = {}
            for i, r in enumerate(reqs):
                if i in qset:
                    continue
                fp = fingerprint(r)
                verdict = vcache.lookup(None, uuid, fp)
                if verdict is not None:
                    self._trace_cached_span(
                        spans[i] if spans and i < len(spans) else None
                    )
                    cached_idx.append(i)
                    cached_verdicts.append(verdict)
                    continue
                first = seen.get(fp)
                if first is not None:
                    dups.setdefault(first, []).append(i)
                    continue
                seen[fp] = i
                fps[i] = fp
                device_idx.append(i)
        else:
            device_idx = [i for i in range(bw.n_req) if i not in qset]
        if dups:
            self.window_dedup_rows += sum(len(v) for v in dups.values())
        if not qidx and not cached_idx and not dups:
            if vcache is None:
                return None
            # Every row is a unique miss: keep the zero-copy blob
            # dispatch; the fingerprints ride along so the collect
            # stage can warm the cache from the fresh verdicts.
            g = _Group(
                engine=engine,
                idxs=list(range(bw.n_req)),
                t_dispatch=time.monotonic(),
                fps=fps,
                cache_uuid=uuid,
            )
            try:
                if not self.phase_split and hasattr(engine, "prepare_blob"):
                    g.inflight = engine.prepare_blob(bw.blob, bw.n_req)
                elif self.phase_split:
                    g.verdicts = engine.evaluate_phased(reqs)
                else:
                    g.verdicts = engine.evaluate(reqs)
            except Exception as err:
                g.error = err
            return _WindowRecord(window=bw, groups=[g], t_win=time.monotonic())
        groups: list[_Group] = []
        if device_idx:
            g = _Group(
                engine=engine,
                idxs=device_idx,
                t_dispatch=time.monotonic(),
                reqs=[reqs[i] for i in device_idx],
                fps=fps or None,
                dups=dups or None,
                cache_uuid=uuid,
            )
            try:
                if self.phase_split:
                    g.verdicts = engine.evaluate_phased(g.reqs)
                elif hasattr(engine, "prepare"):
                    g.inflight = engine.prepare(g.reqs)
                else:
                    g.verdicts = engine.evaluate(g.reqs)
            except Exception as err:
                g.error = err
            groups.append(g)
        if cached_idx:
            groups.append(
                _Group(
                    engine=engine,
                    idxs=cached_idx,
                    t_dispatch=time.monotonic(),
                    cached=True,
                    verdicts=cached_verdicts,
                )
            )
        if qidx:
            groups.append(
                _Group(
                    engine=engine,
                    idxs=qidx,
                    t_dispatch=time.monotonic(),
                    quarantined=True,
                    reqs=[reqs[i] for i in qidx],
                )
            )
        return _WindowRecord(
            window=bw, groups=groups, split=True, t_win=time.monotonic()
        )

    # -- collect stage -------------------------------------------------------

    def _collect_loop(self) -> None:
        while True:
            record = self._inflight.get()
            if record is None:
                # stop() enqueues the sentinel AFTER the dispatch thread
                # exits, so every dispatched window was already drained.
                return
            try:
                self._collect_record(record)
                self._commit_log(record)
            except Exception as err:
                # Backstop: anything escaping per-group handling must
                # not kill the collector — queued windows would never
                # resolve and the depth-slot pool would drain while the
                # sidecar still looks alive. Fail this record's
                # unresolved futures and keep collecting.
                log.error("window collect failed", err)
                if isinstance(record.window, _BlobWindow):
                    if not record.window.fut.done():
                        _resolve(record.window.fut.set_exception, err)
                else:
                    for item in record.window:
                        fut = item[2]
                        if not fut.done():
                            _resolve(fut.set_exception, err)
            finally:
                with self._inflight_lock:
                    self._inflight_count -= 1
                self._depth_gates[record.lane].release()
                # The lane's open window may be waiting for it to go idle.
                self._queues[record.lane].wake()

    # -- dispatch watchdog ---------------------------------------------------

    def _window_deadline_for(self, engine) -> float | None:
        """Effective per-window device deadline, or None (watchdog off).

        Explicit ``window_deadline_s`` wins (<= 0 disables); otherwise
        auto: 10x the warm p99 step latency, floored at 1s. Either way
        the deadline only arms on a WARMED engine with enough latency
        samples — a cold XLA compile legitimately blocks for minutes and
        must never be abandoned."""
        d = self.window_deadline_s
        if d is not None and d <= 0:
            return None
        if not getattr(engine, "warmed", False):
            return None
        if d is not None:
            return d
        lats = self.stats.step_latencies_s
        if len(lats) < self._deadline_min_samples:
            return None
        return max(1.0, 10.0 * _nearest_rank(sorted(lats), 0.99))

    def _spawn_readback_worker(self) -> None:
        if self._readback_q is None:
            self._readback_q = queue.Queue()
        self._readback_thread = threading.Thread(
            target=self._readback_loop,
            name="batcher-readback",
            daemon=True,
        )
        self._readback_thread.start()

    def _readback_loop(self) -> None:
        q = self._readback_q
        while True:
            job = q.get()
            if job is None:
                return
            try:
                verdicts = job.engine.collect(job.inflight)
                error = None
            except BaseException as err:
                verdicts, error = None, err
            with job.lock:
                job.verdicts = verdicts
                job.error = error
                abandoned = job.abandoned
                job.done.set()
            if abandoned:
                # Late completion of an abandoned window: its futures
                # were already failed over to fallback. Account the
                # un-parking, surface loss-class errors to the fault
                # classifier (a DEVICE_LOST landing late must still
                # reach the device-loss manager), and EXIT — a
                # replacement worker owns the queue since the abandon.
                with self._inflight_lock:
                    self.parked_readbacks -= 1
                log.error(
                    "abandoned window readback completed late",
                    error,
                    parked=self.parked_readbacks,
                )
                if error is not None:
                    self._notify(self.on_window_fault, job.engine, error, None)
                return

    def _collect_group(self, g: _Group) -> list[Verdict]:
        """Collect one device group's readback, supervised by the window
        deadline when armed. Raises ``WindowAbandoned`` on a blown
        deadline; the group's futures then fail with it and the server's
        rescue paths re-answer them from host fallback. Time in which the
        whole process stalled does not count (``_wait_running``)."""
        deadline = self._window_deadline_for(g.engine)
        if deadline is None:
            return g.engine.collect(g.inflight)
        # Age from dispatch time, but give every window a grace floor:
        # a window queued behind an abandoned one must not be charged
        # the full wait and spuriously abandoned in a cascade.
        elapsed = time.monotonic() - g.t_dispatch
        budget = max(deadline - elapsed, min(deadline, 1.0))
        if self._readback_thread is None or not self._readback_thread.is_alive():
            self._spawn_readback_worker()
        job = _ReadbackJob(engine=g.engine, inflight=g.inflight)
        self._readback_q.put(job)
        if not _wait_running(job.done, budget):
            with job.lock:
                if not job.done.is_set():
                    # Lost the race for good: park the readback and move
                    # the FIFO along. The worker thread stays blocked in
                    # collect(); a fresh worker takes over the queue.
                    job.abandoned = True
            if job.abandoned:
                with self._inflight_lock:
                    self.windows_abandoned += 1
                    self.parked_readbacks += 1
                self._spawn_readback_worker()
                raise WindowAbandoned(
                    f"device readback exceeded the window deadline "
                    f"({deadline:.3f}s); window abandoned to host fallback"
                )
        if job.error is not None:
            raise job.error
        return job.verdicts

    # -- flight recorder (observability/tracing.py) --------------------------

    def _group_spans(self, record: _WindowRecord, g: _Group) -> tuple:
        """Recording SpanContexts for one group's requests. Empty (the
        steady state) when the window carries no traced requests."""
        if isinstance(record.window, _BlobWindow):
            spans = record.window.spans
            if not spans:
                return ()
            out = []
            for i in g.idxs if g.idxs else range(record.window.n_req):
                s = spans[i] if i < len(spans) else None
                if s is not None and s.recording:
                    out.append(s)
            return tuple(out)
        out = []
        for i in g.idxs:
            s = record.window[i][3]
            if s is not None and s.recording:
                out.append(s)
        return tuple(out)

    def _trace_group(self, record: _WindowRecord, g: _Group, spans: tuple) -> None:
        """Stamp the pipeline span chain (queue -> assemble -> dispatch
        -> readback -> decode) onto a collected group's traced requests,
        copied from the window's measured spans, each naming the window:
        queue from the request's submit (in a blob window, its accept) to
        the window's close, the engine's assemble, dispatch (copy-in to
        the post stage's dispatch, the prefilter confirm included), the
        final read-back's wait, the decode. Must run BEFORE the group's
        futures resolve — the frontend commits the flight record when its
        future lands. Sync groups (stub engines, phase-split) measure no
        stage; their spans are zero-length at the collect and the chain
        stays complete."""
        try:
            t_end = time.monotonic()
            t_win = record.t_win or g.t_dispatch
            measured = g.inflight.spans if g.inflight is not None else ()

            def span_of(*names):
                ivs = [(t0, t1) for name, t0, t1 in measured if name in names]
                if not ivs:
                    return t_end, t_end
                return min(t0 for t0, _ in ivs), max(t1 for _, t1 in ivs)

            chain = (
                ("assemble", span_of("assemble"), "pipeline"),
                ("dispatch", span_of("copy_in", "match_dispatch", "confirm_wait",
                                     "confirm_search", "post_dispatch"), "pipeline"),
                ("readback", span_of("readback_wait"), "device"),
                ("decode", span_of("decode"), "device"),
            )
            n = len(g.idxs) if g.idxs else getattr(record.window, "n_req", 0)
            wid = record.log.id if record.log is not None else None
            submits = {}
            if not isinstance(record.window, _BlobWindow):
                submits = {id(it[3]): it[5] for it in record.window if it[3] is not None}
            for span in spans:
                t_sub = submits.get(id(span), span.t_accept)
                span.event("queue", min(t_sub, t_win), t_win, track="pipeline",
                           args={"window": wid})
                for name, (t0, t1), track in chain:
                    span.event(name, t0, t1, track=track,
                               args={"window": wid, "requests": n} if name == "assemble"
                               else {"window": wid})
        except Exception as err:  # tracing must never decide a verdict
            log.error("flight recorder stamp failed", err)

    def _commit_log(self, record: _WindowRecord) -> None:
        """Commit the window's record to the window log, its futures
        resolved: the engine groups' measured spans and device intervals."""
        rec = record.log
        if rec is None:
            return
        try:
            rec.t_done = time.monotonic()
            for g in record.groups:
                inf = g.inflight
                if inf is None:
                    continue
                rec.spans += inf.spans
                rec.device += inf.device
                rec.seg_rows += inf.seg_rows
                rec.seg_col_rows += inf.seg_col_rows
                if inf.slack_s is not None:
                    rec.slack_s = max(inf.slack_s, rec.slack_s or inf.slack_s)
            WINDOWS.commit(rec)
        except Exception as err:  # the window log must never decide a verdict
            log.error("window log commit failed", err)

    def _trace_degraded(
        self, record: _WindowRecord, g: _Group, path: str, name: str
    ) -> None:
        """Tag a group's traced requests with a degraded branch (event
        on the degraded track + path annotation) before their futures
        resolve/fail."""
        try:
            t_end = time.monotonic()
            for span in self._group_spans(record, g):
                span.annotate_path(path)
                span.event(name, g.t_dispatch, t_end, track="degraded")
        except Exception as err:
            log.error("flight recorder stamp failed", err)

    def _window_fault(self, g: _Group, requests_fn) -> None:
        """Classify a device-window fault. ``on_window_fault`` (the
        sidecar's taxonomy: loss-class -> DeviceLossManager, else
        quarantine bisector, else breaker) supersedes the legacy
        ``on_engine_error`` breaker feed when wired; raw-batcher users
        keep the old behavior exactly."""
        if self.on_window_fault is not None:
            try:
                self.on_window_fault(g.engine, g.error, requests_fn)
                return
            except Exception as err:
                log.error("window fault hook failed", err)
        self._notify(self.on_engine_error, g.engine, g.error)

    def _quarantine_eval(self, g: _Group) -> list[Verdict]:
        """Answer a quarantined group off the device path."""
        reqs = g.reqs or []
        if self.fallback_evaluate is not None:
            return self.fallback_evaluate(g.engine, reqs)
        fallback = getattr(g.engine, "host_fallback", None)
        if fallback is not None:
            return fallback.evaluate(reqs)
        return g.engine.evaluate(reqs)

    def _collect_quarantined(self, record: _WindowRecord, g: _Group) -> None:
        """Resolve a quarantined group's futures from host fallback —
        no breaker traffic, no device stats, no shadow mirror."""
        self._trace_degraded(record, g, "quarantine", "quarantine")
        try:
            verdicts = self._quarantine_eval(g)
        except Exception as err:
            self.stats.errors += len(g.idxs)
            log.error("quarantined group evaluation failed", err, batch=len(g.idxs))
            for i in g.idxs:
                _resolve(record.window[i][2].set_exception, err)
            return
        for i, verdict in zip(g.idxs, verdicts):
            _resolve(record.window[i][2].set_result, verdict)

    # -- verdict cache (sidecar/verdict_cache.py) ----------------------------

    def _cache_uuid(self, engine):
        """Cache-key component naming the engine's compiled ruleset.
        Falls back to ``id(engine)`` when no resolver is wired (raw
        batcher users) — the sidecar's wholesale invalidation on every
        swap still guards staleness."""
        fn = self.cache_key_fn
        if fn is not None:
            try:
                uuid = fn(engine)
                if uuid is not None:
                    return uuid
            except Exception as err:
                log.error("cache_key_fn hook failed", err)
        return id(engine)

    def _cache_insert(self, g: _Group) -> None:
        """Remember a device group's fresh verdicts under the
        fingerprints computed at assembly time (collect stage; a
        failing cache must never decide a verdict)."""
        vcache = self.verdict_cache
        if vcache is None or not g.fps or g.verdicts is None:
            return
        try:
            for i, verdict in zip(g.idxs, g.verdicts):
                fp = g.fps.get(i)
                if fp is not None:
                    vcache.insert(None, g.cache_uuid, fp, verdict)
        except Exception as err:
            log.error("verdict cache insert failed", err)

    @staticmethod
    def _trace_cached_span(span) -> None:
        """Stamp a verdict-cache hit onto one flight record (no-op for
        untraced requests; never raises)."""
        if span is None or not getattr(span, "recording", False):
            return
        try:
            now = time.monotonic()
            span.annotate_path("verdict_cache")
            span.event("verdict_cache_hit", now, now, track="pipeline")
        except Exception as err:
            log.error("flight recorder stamp failed", err)

    def _collect_record(self, record: _WindowRecord) -> None:
        if isinstance(record.window, _BlobWindow):
            self._collect_blob(record)
            return
        for g in record.groups:
            if g.quarantined:
                self._collect_quarantined(record, g)
                continue
            if g.error is None and g.verdicts is None:
                try:
                    g.verdicts = self._collect_group(g)
                except Exception as err:
                    g.error = err
            if g.error is not None:
                if g.engine is None:
                    # Missing-engine group: a routing condition, not a
                    # device failure — never feeds the breaker.
                    self.stats.errors += len(g.idxs)
                    self._trace_degraded(record, g, "unavailable", "unavailable")
                    for i in g.idxs:
                        _resolve(record.window[i][2].set_exception, g.error)
                    continue
                log.error("batch evaluation failed", g.error, batch=len(g.idxs))
                self.stats.errors += len(g.idxs)
                self._window_fault(
                    g, lambda g=g: [record.window[i][0] for i in g.idxs]
                )
                if isinstance(g.error, WindowAbandoned):
                    self._trace_degraded(record, g, "abandoned", "abandon")
                else:
                    self._trace_degraded(record, g, "error", "window_error")
                for i in g.idxs:
                    _resolve(record.window[i][2].set_exception, g.error)
                    for j in g.dups.get(i, ()) if g.dups else ():
                        # Duplicates share their unique row's fate — the
                        # server's rescue paths re-answer each future.
                        _resolve(record.window[j][2].set_exception, g.error)
                continue
            self._notify(self.on_engine_success, g.engine)
            spans = self._group_spans(record, g)
            # One stats sample per model group, recorded BEFORE the
            # futures resolve: a caller that reads /stats right after its
            # verdict lands must see its own request counted. Each group
            # is its own device step, so waf_batch_step_seconds /
            # waf_batch_size keep measuring a single device batch even in
            # multi-tenant windows. Latency spans dispatch start ->
            # collect end: the true window residency a caller observes
            # under pipelining.
            trace_id = spans[0].trace_id if spans else None
            try:
                self.stats.record(
                    len(g.idxs), time.monotonic() - g.t_dispatch, trace_id
                )
                inflight = g.inflight
                if inflight is not None:
                    self.stats.record_stage(inflight.host_s, inflight.device_s, trace_id)
            except Exception as err:  # metrics hooks must not fail verdicts
                log.error("batch stats hook failed", err)
            if spans:
                self._trace_group(record, g, spans)
            for i, verdict in zip(g.idxs, g.verdicts):
                _resolve(record.window[i][2].set_result, verdict)
                for j in g.dups.get(i, ()) if g.dups else ():
                    # In-window duplicate: the SAME verdict answers
                    # every requester that shared the fingerprint.
                    _resolve(record.window[j][2].set_result, verdict)
            self._cache_insert(g)
            if self.on_window is not None:
                inflight = g.inflight
                serving_s = (
                    inflight.host_s + inflight.readback_s + inflight.decode_s
                    if inflight is not None
                    else time.monotonic() - g.t_dispatch
                )
                self._notify(
                    self.on_window,
                    g.engine,
                    [record.window[i][0] for i in g.idxs],
                    list(g.verdicts),
                    serving_s,
                )

    def _collect_blob(self, record: _WindowRecord) -> None:
        """Collect one blob window: resolve its single future with the
        verdict list, feed the breaker hooks, and (only when a rollout
        is actually shadowing this engine) materialize the requests for
        the shadow mirror."""
        bw: _BlobWindow = record.window
        if record.split:
            self._collect_blob_split(record)
            return
        g = record.groups[0]
        if g.error is None and g.verdicts is None:
            try:
                g.verdicts = self._collect_group(g)
            except Exception as err:
                g.error = err
        if g.error is not None:
            self.stats.errors += bw.n_req
            if g.engine is not None:
                log.error("blob window evaluation failed", g.error, batch=bw.n_req)
                self._window_fault(g, lambda: _blob_requests_fn(bw))
            if g.engine is None:
                self._trace_degraded(record, g, "unavailable", "unavailable")
            elif isinstance(g.error, WindowAbandoned):
                self._trace_degraded(record, g, "abandoned", "abandon")
            else:
                self._trace_degraded(record, g, "error", "window_error")
            _resolve(bw.fut.set_exception, g.error)
            return
        self._notify(self.on_engine_success, g.engine)
        spans = self._group_spans(record, g)
        trace_id = spans[0].trace_id if spans else None
        inflight = g.inflight
        serving_s = (
            inflight.host_s + inflight.readback_s + inflight.decode_s
            if inflight is not None
            else time.monotonic() - g.t_dispatch
        )
        # Account BEFORE resolving: a caller that reads /stats right
        # after its verdict lands must see its own window counted.
        try:
            self.stats.record(bw.n_req, time.monotonic() - g.t_dispatch, trace_id)
            if inflight is not None:
                self.stats.record_stage(inflight.host_s, inflight.device_s, trace_id)
        except Exception as err:  # metrics hooks must not fail verdicts
            log.error("batch stats hook failed", err)
        if spans:
            self._trace_group(record, g, spans)
        _resolve(bw.fut.set_result, list(g.verdicts))
        self._cache_insert(g)
        if self.on_window is not None and (
            self.window_wanted is None or self._wants_window(g.engine)
        ):
            from ..native import blob_requests

            try:
                reqs = blob_requests(bw.blob, bw.n_req)
            except Exception as err:
                log.error("blob window mirror materialization failed", err)
                reqs = None
            if reqs is not None:
                self._notify(
                    self.on_window, g.engine, reqs, list(g.verdicts), serving_s
                )

    def _collect_blob_split(self, record: _WindowRecord) -> None:
        """Collect a quarantine-split blob window: the clean device
        group and the quarantined fallback group each produce verdicts
        for their idxs, stitched back into one list for the window
        future. Any group failure fails the whole window future (the
        server's rescue re-answers it from fallback — no verdict lost).
        The shadow mirror is skipped in split mode (sampling loss while
        a quarantine is active is acceptable)."""
        bw: _BlobWindow = record.window
        out: list[Verdict | None] = [None] * bw.n_req
        for g in record.groups:
            try:
                if g.quarantined:
                    self._trace_degraded(record, g, "quarantine", "quarantine")
                    verdicts = self._quarantine_eval(g)
                elif g.cached:
                    # Answered from the verdict cache at assembly time:
                    # no device step, no breaker traffic, no stats
                    # sample — the hit accounting lives in the cache.
                    verdicts = g.verdicts
                else:
                    if g.error is not None:
                        raise g.error
                    if g.verdicts is None:
                        g.verdicts = self._collect_group(g)
                    verdicts = g.verdicts
            except Exception as err:
                self.stats.errors += bw.n_req
                log.error(
                    "split blob window evaluation failed", err, batch=bw.n_req
                )
                if not g.quarantined and not g.cached and g.engine is not None:
                    g.error = err
                    self._window_fault(g, lambda g=g: g.reqs)
                _resolve(bw.fut.set_exception, err)
                return
            if not g.quarantined and not g.cached:
                self._notify(self.on_engine_success, g.engine)
                spans = self._group_spans(record, g)
                try:
                    self.stats.record(
                        len(g.idxs),
                        time.monotonic() - g.t_dispatch,
                        spans[0].trace_id if spans else None,
                    )
                except Exception as err:
                    log.error("batch stats hook failed", err)
                if spans:
                    self._trace_group(record, g, spans)
            for i, verdict in zip(g.idxs, verdicts):
                out[i] = verdict
                for j in g.dups.get(i, ()) if g.dups else ():
                    # In-window duplicate: the SAME verdict answers
                    # every row that shared the fingerprint.
                    out[j] = verdict
            self._cache_insert(g)
        _resolve(bw.fut.set_result, out)

    def _wants_window(self, engine) -> bool:
        try:
            return bool(self.window_wanted(engine))
        except Exception as err:
            log.error("window_wanted hook failed", err)
            return False

    def _notify(self, hook, *args) -> None:
        """Degraded-mode/metrics hooks are side channels: a raising hook
        must never decide a verdict or kill the collector."""
        if hook is None:
            return
        try:
            hook(*args)
        except Exception as err:
            log.error("batcher hook failed", err)


def _open_log(record: _WindowRecord) -> WindowRecord:
    """The dispatched window's record on the window log: its requests, the
    sums of their ext_proc-worker and batcher waits (to the window's
    close), and why it closed."""
    t, w = record.t_win, record.window
    if isinstance(w, _BlobWindow):
        return WINDOWS.open(t, w.n_req, 0.0, w.n_req * max(0.0, t - w.t_submit), record.close)
    return WINDOWS.open(
        t, len(w), sum(it[6] for it in w), sum(max(0.0, t - it[5]) for it in w), record.close
    )


def _blob_requests_fn(bw: _BlobWindow):
    """Materialize a blob window's requests for the fault classifier
    (only called when a window actually faulted — never on the hot
    path)."""
    from ..native import blob_requests

    return blob_requests(bw.blob, bw.n_req)


def _resolve(setter, value) -> None:
    """Set a future's result/exception, tolerating callers that CANCELLED
    the future (deadline-missed requests re-answered by the fallback
    cancel their queued submissions so the device never evaluates
    abandoned work)."""
    try:
        setter(value)
    except Exception:  # InvalidStateError: cancelled by a deadline waiter
        pass


class EngineUnavailable(RuntimeError):
    """Raised when a window runs with no loaded ruleset; the server maps this
    through the Engine failurePolicy (fail-closed 503 / fail-open pass)."""


class WindowAbandoned(RuntimeError):
    """The dispatch watchdog gave up on a window's device readback (the
    per-window deadline blew). The window's futures fail with this; the
    server's rescue paths re-answer them from the host fallback, so the
    caller still gets a real verdict. The stuck readback keeps running
    on a parked worker thread (``cko_parked_readbacks``)."""
