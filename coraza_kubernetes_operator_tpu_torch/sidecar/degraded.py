"""Degraded-mode serving: mode state machine, promotion, circuit breaker.

The sidecar's hard invariant (docs/DEGRADED_MODE.md): **a verdict is
always returned before the deadline** — warm caches are an optimization,
never a precondition. This module owns the per-engine serving-mode state
machine:

    cold ──ruleset loads──▶ fallback ──first device batch──▶ promoted
                               ▲                                │
                               └──── breaker opens (broken) ◀───┘

- **cold**: no compiled ruleset — the Engine ``failurePolicy`` decides
  (fail-closed 503 / fail-open pass), exactly as before.
- **fallback**: a ruleset is loaded but its XLA executables are not
  proven yet. Every request is answered by the host fallback evaluator
  (``engine/host_fallback.py`` — bit-identical verdicts, no JAX) while a
  background probe thread runs the first device batch. The moment it
  completes, the engine atomically promotes (``engine.warmed`` flips).
- **promoted**: requests ride the micro-batcher/device path.
- **broken**: N consecutive device failures opened the circuit breaker
  (CRITICAL log + ``cko_breaker_state`` metric). Serving demotes to the
  fallback evaluator; after a cooldown one half-open probe per window
  re-tries the device, closing the breaker on success.

The reference operator carries ``failurePolicy`` for exactly this class
of failure but its data plane has no second evaluator to fall back on
(SURVEY §5); the host scalar-DFA path (cf. Hyperflex, arXiv:2512.07123;
approximate-NFA DPI, arXiv:1904.10786) is fast enough to be that
stopgap.

Composition with staged rollouts (``sidecar/rollout.py``, docs/ROLLOUT.md):
a rollout candidate is prewarmed and canary-proven inside its compile
budget, so a PROMOTED candidate arrives already ``warmed`` — ``mode_for``
reports ``promoted`` immediately and the swap costs no fallback window.
Candidate faults during shadow verification never reach this module's
breaker (shadowing runs off the batcher, and only the batcher's outcome
hooks feed ``record_device_failure``); conversely, while the baseline is
cold/fallback/broken there is no proven device path to mirror against,
so the rollout skips shadowing and swaps directly — this state machine
then warms the new engine exactly as it always has.
"""

from __future__ import annotations

import os
import threading
import time

from ..engine.request import HttpRequest
from ..engine.waf import warmup_request
from ..utils import get_logger

log = get_logger("sidecar.degraded")

# Device-loss recovery states (docs/RECOVERY.md). Distinct from the
# transient breaker: a lost device needs its arrays RE-PUT on a fresh
# backend, not a cooldown-and-retry.
DEVICE_OK = "ok"
DEVICE_REINIT = "reinit"
DEVICE_EXHAUSTED = "exhausted"

# Knobs (None config fields read these at construction):
DEVICE_LOST_THRESHOLD_ENV = "CKO_DEVICE_LOST_THRESHOLD"  # default 5
DEVICE_REINIT_ATTEMPTS_ENV = "CKO_DEVICE_REINIT_ATTEMPTS"  # default 3
DEVICE_REINIT_BACKOFF_ENV = "CKO_DEVICE_REINIT_BACKOFF_S"  # default 0.5

# Substrings that mark an error as device-LOSS class (the backend is
# gone) rather than a transient kernel fault; the fault harness raises
# DeviceLostFault. The CUDA ones are cudaGetErrorString texts, as torch's
# errors and the kernel launchers (ops/kernels.py::check) carry them: the
# sticky errors that poison the process's CUDA context (illegal address,
# launch failure, device-side assert, ...) and a device that is gone or
# unavailable. After a sticky error no call on the context succeeds, so
# the bounded re-init loop below exhausts and the mode escalates to
# ``broken`` (readyz 503): the path to a process restart.
_DEVICE_LOSS_MARKERS = (
    "device_lost",
    "device lost",
    "device unavailable",
    "device disappeared",
    "illegal memory access",
    "illegal address",
    "illegal instruction",
    "misaligned address",
    "invalid program counter",
    "hardware stack error",
    "unspecified launch failure",
    "launch timed out",
    "device-side assert",
    "uncorrectable ecc error",
    "busy or unavailable",
    "no cuda-capable device",
    "fallen off the bus",
)


def is_device_loss(err: BaseException) -> bool:
    """True when ``err`` is a device-loss-class failure: the injected
    :class:`~..testing.faults.DeviceLostFault`, or a runtime error whose
    text carries a device-loss marker (XLA's ``DEVICE_LOST`` class or a
    sticky / device-gone CUDA error)."""
    from ..testing.faults import DeviceLostFault

    if isinstance(err, DeviceLostFault):
        return True
    text = f"{type(err).__name__}: {err}".lower()
    return any(marker in text for marker in _DEVICE_LOSS_MARKERS)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class DeviceLossManager:
    """Persistent device-loss handling, distinct from the circuit breaker.

    The breaker guards against TRANSIENT device faults: open, cool down,
    half-open probe the same arrays. A device LOSS (TPU runtime restart,
    ``DEVICE_LOST`` class errors) invalidates every array the engines
    hold — probing them forever can never recover. This manager declares
    a loss on one device-loss-class error or ``threshold`` consecutive
    device errors of any kind, then runs a bounded, backed-off re-init
    loop: re-put every resident engine's model arrays on a fresh backend
    (``WafEngine.reinit_device``) and prove the path with the canonical
    canary through the same prepare/collect split the batcher serves on.

    While re-init runs, serving mode is ``fallback`` (host evaluator —
    no verdict is ever lost; the window that observed the loss is
    re-answered by the server's existing fallback rescue). Only when
    every attempt is exhausted does the mode escalate to ``broken``
    (readyz 503, replica out of rotation). Success closes the breaker
    and resumes device serving through normal promotion.
    """

    def __init__(
        self,
        engines_fn,
        threshold: int | None = None,
        max_attempts: int | None = None,
        backoff_s: float | None = None,
        on_lost=None,
        on_recovered=None,
    ):
        # engines_fn() -> iterable of CURRENT resident engines (the
        # sidecar supplies distinct serving engines across tenants).
        self._engines_fn = engines_fn
        if threshold is None:
            threshold = int(_env_float(DEVICE_LOST_THRESHOLD_ENV, 5))
        if max_attempts is None:
            max_attempts = int(_env_float(DEVICE_REINIT_ATTEMPTS_ENV, 3))
        if backoff_s is None:
            backoff_s = _env_float(DEVICE_REINIT_BACKOFF_ENV, 0.5)
        self.threshold = max(1, threshold)
        self.max_attempts = max(1, max_attempts)
        self.backoff_s = max(0.05, backoff_s)
        self._on_lost = on_lost  # () -> None, e.g. cko_device_lost_total.inc
        self._on_recovered = on_recovered  # () -> None, e.g. breaker close
        self._lock = threading.Lock()
        self._state = DEVICE_OK
        self._consecutive = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.losses_total = 0
        self.reinit_attempts = 0
        self.reinit_failures = 0
        self.recoveries = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def note_error(self, err: BaseException) -> bool:
        """Feed one device-path failure. Returns True when the error is
        OWNED by the device-loss path (device-loss class — the transient
        breaker must not also count it); generic errors return False and
        keep feeding the breaker while still counting toward the
        consecutive-loss threshold."""
        lost = is_device_loss(err)
        begin = False
        with self._lock:
            if self._state != DEVICE_OK:
                return lost  # a re-init (or exhaustion) is already active
            self._consecutive += 1
            if lost or self._consecutive >= self.threshold:
                self._state = DEVICE_REINIT
                self.losses_total += 1
                begin = True
        if begin:
            log.critical(
                "device LOSS declared: re-putting arrays on a fresh backend",
                err,
                loss_class=lost,
                consecutive=self._consecutive,
                max_attempts=self.max_attempts,
            )
            if self._on_lost is not None:
                try:
                    self._on_lost()
                except Exception as hook_err:
                    log.error("device-loss hook failed", hook_err)
            self._thread = threading.Thread(
                target=self._reinit_loop, name="cko-device-reinit", daemon=True
            )
            self._thread.start()
        return lost

    def note_success(self) -> None:
        with self._lock:
            self._consecutive = 0

    # -- recovery loop -------------------------------------------------------

    def _reinit_loop(self) -> None:
        backoff = self.backoff_s
        for attempt in range(1, self.max_attempts + 1):
            if self._stop.wait(backoff if attempt > 1 else 0.0):
                return
            backoff = min(backoff * 2, 30.0)
            self.reinit_attempts += 1
            try:
                engines = [e for e in self._engines_fn() if e is not None]
                for engine in engines:
                    reinit = getattr(engine, "reinit_device", None)
                    if reinit is not None:
                        reinit()
                # Prove the exact serving path per engine: the canary
                # through prepare/collect (stub engines via evaluate).
                for engine in engines:
                    prepare = getattr(engine, "prepare", None)
                    if prepare is not None:
                        engine.collect(prepare([_canary_request()]))
                    else:
                        engine.evaluate([_canary_request()])
            except Exception as err:
                self.reinit_failures += 1
                log.error(
                    "device re-init attempt failed",
                    err,
                    attempt=attempt,
                    max_attempts=self.max_attempts,
                )
                continue
            with self._lock:
                self._state = DEVICE_OK
                self._consecutive = 0
                self.recoveries += 1
            log.info("device path recovered after loss", attempts=attempt)
            if self._on_recovered is not None:
                try:
                    self._on_recovered()
                except Exception as hook_err:
                    log.error("device-recovered hook failed", hook_err)
            return
        with self._lock:
            self._state = DEVICE_EXHAUSTED
        log.critical(
            "device re-init EXHAUSTED: serving mode escalates to broken",
            attempts=self.max_attempts,
        )

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_errors": self._consecutive,
                "threshold": self.threshold,
                "max_attempts": self.max_attempts,
                "losses_total": self.losses_total,
                "reinit_attempts": self.reinit_attempts,
                "reinit_failures": self.reinit_failures,
                "recoveries": self.recoveries,
            }

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)


MODE_COLD = "cold"
MODE_FALLBACK = "fallback"
MODE_PROMOTED = "promoted"
MODE_BROKEN = "broken"

# Numeric codes for the cko_serving_mode gauge.
MODE_CODES = {MODE_COLD: 0, MODE_FALLBACK: 1, MODE_PROMOTED: 2, MODE_BROKEN: 3}

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"
BREAKER_CODES = {BREAKER_CLOSED: 0, BREAKER_OPEN: 1, BREAKER_HALF_OPEN: 2}


class Overloaded(RuntimeError):
    """Admission control rejected the request (queue backlog over budget).
    The server maps this to 429 + ``Retry-After``."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class BreakerOpen(RuntimeError):
    """The device path is broken and no fallback evaluator is available;
    the server maps this through the Engine ``failurePolicy`` (fail →
    403 deny-by-default, allow → pass-through + ``cko_failopen_total``)."""


class CircuitBreaker:
    """Consecutive-failure breaker over the device evaluation path."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self.opened_total = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def record_failure(self) -> bool:
        """Count one device failure; returns True when this failure OPENED
        the breaker (closed/half-open -> open transition)."""
        with self._lock:
            self._consecutive += 1
            if self._state == BREAKER_OPEN:
                return False
            if self._state == BREAKER_HALF_OPEN or self._consecutive >= self.threshold:
                self._state = BREAKER_OPEN
                self._opened_at = time.monotonic()
                self.opened_total += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._state = BREAKER_CLOSED

    def allow_probe(self) -> bool:
        """When open past the cooldown, transition to half-open and grant
        ONE probe; otherwise False."""
        with self._lock:
            if self._state != BREAKER_OPEN:
                return False
            if time.monotonic() - self._opened_at < self.cooldown_s:
                return False
            self._state = BREAKER_HALF_OPEN
            return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "opened_total": self.opened_total,
            }


def _canary_request() -> HttpRequest:
    # One canonical canary (engine/waf.warmup_request): the probe, the
    # prewarm default, and the rollout canary/idle self-check share one
    # shape signature, so each proves the executable the others reuse.
    return warmup_request()


class DegradedModeManager:
    """Routes requests between the device path and the host fallback."""

    def __init__(
        self,
        fallback_enabled: bool = True,
        breaker: CircuitBreaker | None = None,
        probe_backoff_s: float = 0.5,
        on_fallback=None,
        is_current=None,
    ):
        self.fallback_enabled = fallback_enabled
        # ONE breaker for the whole sidecar, deliberately: the device is a
        # shared resource, and the fault storms this guards against
        # (kernel faults, tunnel drops) are device-wide, not per-model. A
        # single tenant's model-specific evaluation failure will demote
        # every tenant to the fallback — accepted: correctness-preserving
        # (fallback verdicts are identical), and far simpler than
        # per-engine breakers with stale-engine state cleanup.
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.probe_backoff_s = probe_backoff_s
        self._on_fallback = on_fallback  # optional (n_requests,) metrics hook
        # is_current(engine) -> bool: False once a hot reload superseded
        # the engine. Probe loops exit for superseded engines instead of
        # retrying forever (and feeding the breaker) on behalf of an
        # engine nothing serves anymore.
        self._is_current = is_current
        # Optional DeviceLossManager (docs/RECOVERY.md), wired by the
        # sidecar after construction. When set, it classifies device
        # errors ahead of the breaker and owns the re-init recovery.
        self.device_loss: DeviceLossManager | None = None
        self._lock = threading.Lock()
        self._probing: set[int] = set()
        self._stop = threading.Event()
        self.promotions = 0
        self.fallback_requests = 0

    # -- state machine -------------------------------------------------------

    def mode_for(self, engine) -> str:
        if engine is None:
            return MODE_COLD
        dl = self.device_loss
        if dl is not None:
            dl_state = dl.state
            if dl_state == DEVICE_EXHAUSTED:
                return MODE_BROKEN
            if dl_state == DEVICE_REINIT and self.breaker.state == BREAKER_CLOSED:
                # Device loss under active re-init: serve from the host
                # fallback (readyz stays green — no verdict is lost) and
                # escalate to broken only on re-init exhaustion. Loss-class
                # errors bypass the breaker, so it is closed on the pure
                # device-loss path; a generic-error storm that already
                # opened the breaker keeps reading ``broken`` below.
                return MODE_FALLBACK if self.fallback_enabled else MODE_BROKEN
        if self.breaker.state != BREAKER_CLOSED:
            return MODE_BROKEN
        return MODE_PROMOTED if getattr(engine, "warmed", False) else MODE_FALLBACK

    def route(self, engine) -> str:
        """Pick the serving path for one engine: ``"device"`` or
        ``"fallback"``. Kicks the background promotion/half-open probe as
        a side effect. Raises :class:`BreakerOpen` when broken with no
        fallback available."""
        mode = self.mode_for(engine)
        if mode == MODE_PROMOTED:
            return "device"
        if mode == MODE_BROKEN:
            self.ensure_probe(engine)
            if self.fallback_enabled:
                return "fallback"
            raise BreakerOpen(
                "device path broken (circuit breaker open) and host fallback disabled"
            )
        # MODE_FALLBACK: compiled but unproven — promote in the background.
        self.ensure_probe(engine)
        if self.fallback_enabled:
            return "fallback"
        return "device"  # fallback disabled: legacy wait-out-the-compile path

    def fallback_evaluate(self, engine, requests, span=None) -> list:
        """Evaluate on the host fallback path (counts the requests).

        ``span`` is an optional flight-recorder context
        (observability/tracing.py): the fallback evaluation lands on its
        degraded track and the serving path is tagged ``fallback`` —
        the trace shows WHY a request skipped the device chain."""
        with self._lock:
            self.fallback_requests += len(requests)
        if self._on_fallback is not None:
            self._on_fallback(len(requests))
        if span is None:
            return engine.host_fallback.evaluate(requests)
        t0 = time.monotonic()
        try:
            return engine.host_fallback.evaluate(requests)
        finally:
            span.annotate_path("fallback")
            span.event("fallback_eval", t0, time.monotonic(), track="degraded")

    # -- breaker feed --------------------------------------------------------

    def record_device_failure(self, err: BaseException) -> None:
        dl = self.device_loss
        if dl is not None and dl.note_error(err):
            # Device-loss-class error: owned by the re-init state machine;
            # the transient breaker must not also count it (its half-open
            # probes can never revive arrays whose backend is gone).
            return
        opened = self.breaker.record_failure()
        if opened:
            # CRITICAL: the data plane lost its device path. Serving
            # continues on the host fallback (or the failurePolicy).
            log.critical(
                "circuit breaker OPEN: device path demoted to host fallback",
                err,
                threshold=self.breaker.threshold,
                cooldown_s=self.breaker.cooldown_s,
            )

    def record_device_success(self) -> None:
        if self.device_loss is not None:
            self.device_loss.note_success()
        self.breaker.record_success()

    # -- promotion / half-open probe ----------------------------------------

    def ensure_probe(self, engine) -> None:
        """Start (at most one) background thread that proves the engine's
        device path: the first successful batch both warms the engine
        (promotion) and closes the breaker."""
        dl = self.device_loss
        if dl is not None and dl.state == DEVICE_REINIT:
            # The device-loss re-init loop owns recovery: its canary
            # proves a FRESH backend; probing the stale arrays here would
            # only feed noise into the breaker.
            return
        key = id(engine)
        with self._lock:
            if key in self._probing:
                return
            if getattr(engine, "warmed", False) and self.breaker.state == BREAKER_CLOSED:
                return
            self._probing.add(key)
        threading.Thread(
            target=self._probe_loop,
            args=(engine, key),
            name=f"cko-promote-{key:x}",
            daemon=True,
        ).start()

    def _probe_loop(self, engine, key: int) -> None:
        backoff = self.probe_backoff_s
        try:
            while not self._stop.is_set():
                if self._is_current is not None and not self._is_current(engine):
                    # A reload superseded this engine: stop probing on its
                    # behalf — its failures must not re-open the breaker
                    # against the engine that replaced it.
                    return
                if self.breaker.state == BREAKER_OPEN and not self.breaker.allow_probe():
                    if self._stop.wait(0.2):
                        return
                    continue
                t0 = time.monotonic()
                try:
                    # AOT pre-warm (shape-canonical executable reuse): lower
                    # + compile the canary signature WITHOUT executing, so
                    # the compile happens here — off the serving path — and
                    # lands in the process-wide executable cache (and the
                    # persistent disk cache). When a hot reload kept the
                    # shape signature, this is a pure cache hit: zero XLA
                    # compiles, promotion in milliseconds.
                    prewarm = getattr(engine, "prewarm", None)
                    if prewarm is not None:
                        warm = prewarm([_canary_request()])
                        if warm.get("compiled"):
                            log.info(
                                "promotion pre-warm compiled executable",
                                wall_s=round(warm["wall_s"], 2),
                            )
                    # Prove the exact path the batcher serves on: the
                    # pipelined prepare/collect split (one dispatch site
                    # with the synchronous path, so the prewarmed
                    # signature is a pure cache hit here and promotion
                    # never eats a first-dispatch stall on either path).
                    prepare = getattr(engine, "prepare", None)
                    if prepare is not None:
                        engine.collect(prepare([_canary_request()]))
                    else:
                        engine.evaluate([_canary_request()])
                except Exception as err:
                    self.record_device_failure(err)
                    if self._stop.wait(backoff):
                        return
                    backoff = min(backoff * 2, 30.0)
                    continue
                self.record_device_success()
                with self._lock:
                    self.promotions += 1
                log.info(
                    "engine promoted to device serving",
                    warmup_s=round(time.monotonic() - t0, 2),
                )
                return
        finally:
            with self._lock:
                self._probing.discard(key)

    def stats(self) -> dict:
        with self._lock:
            probing = len(self._probing)
        out = {
            "fallback_enabled": self.fallback_enabled,
            "fallback_requests": self.fallback_requests,
            "promotions": self.promotions,
            "probing": probing,
            "breaker": self.breaker.snapshot(),
        }
        if self.device_loss is not None:
            out["device_loss"] = self.device_loss.stats()
        return out

    def stop(self) -> None:
        self._stop.set()
        if self.device_loss is not None:
            self.device_loss.stop()
