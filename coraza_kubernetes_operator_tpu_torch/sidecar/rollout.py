"""Staged ruleset rollout: budgeted compile, shadow verification, rollback.

The reload path used to be "compile on the poll thread, gate, swap the
pointer": a 144s cold compile stalled polling for minutes, and a
semantically-wrong-but-analyzer-clean ruleset shipped straight to 100% of
traffic with no way back. This module turns every hot reload into a
staged rollout (docs/ROLLOUT.md) — the Hyperflex-style treatment of rule
updates as an expensive, risky recompile-and-verify pipeline rather than
an atomic pointer swap:

    staged ──compile+prewarm ok──▶ shadowing ──N clean windows──▶ promoted
       │                              │
       └──budget blown / compile /    └──verdict divergence over threshold,
          analysis gate ──▶ failed       candidate device fault, latency
                                         regression, supersession, or
                                         forced ──▶ rolled_back

- **staged**: a budgeted worker thread compiles the candidate
  (``CKO_COMPILE_BUDGET_S``), runs the analysis gate, AOT-prewarms its
  executables (``WafEngine.prewarm`` — the compile happens HERE, never
  on the serving or poll path) and proves the device path with one
  canary dispatch. A blown budget (e.g. ``CKO_FAULT_COMPILE_STALL_S``)
  marks the rollout *failed* and the serving engine is never touched;
  the abandoned compile still lands in the executable/persistent cache
  so the next attempt is cheap (``cko_compile_inflight`` tracks it).
- **shadowing**: the micro-batcher mirrors a configurable sample of live
  windows (requests + the serving engine's verdicts + latency) into the
  candidate via the existing ``prepare``/``collect`` split; verdicts are
  compared with the bit-identical parity predicate
  (``testing/overlap.verdict_tuple``). Idle sidecars self-check with the
  canonical warmup canary so a rollout never hangs waiting for traffic.
- **promoted**: after N clean windows the candidate swaps in (the
  reloader pushes the previous engine into a last-known-good ring,
  depth ≥ 2) — already warmed, so degraded-mode serving sees it as
  ``promoted`` immediately.
- **rolled_back**: divergence above threshold, a candidate device
  fault, or a latency regression discards the candidate; the serving
  engine was never perturbed. ``POST /waf/v1/rollback`` additionally
  force-rolls the *serving* engine back to the ring's previous entry.

Composition with degraded-mode serving (``sidecar/degraded.py``): shadow
evaluation happens entirely OFF the batcher, so a candidate's device
faults never feed the serving circuit breaker; shadow gating only
applies when the baseline engine is promoted (warmed) — a cold/fallback
baseline swaps directly, exactly the old semantics, because there is no
healthy device path to mirror against.
"""

from __future__ import annotations

import os
import queue
import random
import threading
import time
from collections import deque
from dataclasses import dataclass

from ..engine.waf import warmup_request
from ..testing.overlap import verdict_tuple
from ..utils import get_logger

log = get_logger("sidecar.rollout")

ROLLOUT_IDLE = "idle"
ROLLOUT_STAGED = "staged"
ROLLOUT_SHADOWING = "shadowing"
ROLLOUT_PROMOTED = "promoted"
ROLLOUT_ROLLED_BACK = "rolled_back"
ROLLOUT_FAILED = "failed"

# Numeric codes for the cko_rollout_state gauge.
ROLLOUT_CODES = {
    ROLLOUT_IDLE: 0,
    ROLLOUT_STAGED: 1,
    ROLLOUT_SHADOWING: 2,
    ROLLOUT_PROMOTED: 3,
    ROLLOUT_ROLLED_BACK: 4,
    ROLLOUT_FAILED: 5,
}

_TERMINAL = (ROLLOUT_PROMOTED, ROLLOUT_ROLLED_BACK, ROLLOUT_FAILED)


class RolloutRefused(RuntimeError):
    """The candidate was refused before shadowing (analysis gate)."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class RolloutConfig:
    """Knobs (docs/ROLLOUT.md). ``None`` fields read their env var at
    construction so the operator can tune a fleet without a redeploy."""

    # Wall budget for the whole staging phase: compile + analysis gate +
    # prewarm + canary dispatch. Blown ⇒ rollout failed, serving engine
    # untouched, polls never stalled.
    compile_budget_s: float | None = None  # CKO_COMPILE_BUDGET_S (600)
    # Fraction of live batch windows mirrored through the candidate.
    sample_rate: float | None = None  # CKO_SHADOW_SAMPLE_RATE (1.0)
    # Clean (zero-divergence) shadow windows required to promote.
    promote_windows: int | None = None  # CKO_SHADOW_PROMOTE_WINDOWS (3)
    # Cumulative diverged-request fraction above which the candidate
    # rolls back (0.0 = any divergence).
    diverge_threshold: float | None = None  # CKO_SHADOW_DIVERGE_THRESHOLD (0.0)
    # Candidate cumulative shadow latency > ratio × serving latency at
    # promotion time ⇒ rollback. <= 0 disables the check.
    latency_ratio: float | None = None  # CKO_SHADOW_LATENCY_RATIO (10.0)
    # With no live window mirrored for this long, the shadow loop
    # self-checks with the canonical warmup canary (idle sidecars must
    # still converge; the canary signature is prewarmed — no compiles).
    idle_check_s: float | None = None  # CKO_SHADOW_IDLE_S (2.0)
    # Bounded mirror queue per rollout; full ⇒ drop + count (mirroring
    # must never backpressure the serving path).
    queue_depth: int | None = None  # CKO_SHADOW_QUEUE_DEPTH (8)
    # Last-known-good engine ring depth per tenant (>= 2).
    ring_depth: int | None = None  # CKO_ROLLOUT_RING (2)

    def __post_init__(self) -> None:
        if self.compile_budget_s is None:
            self.compile_budget_s = _env_float("CKO_COMPILE_BUDGET_S", 600.0)
        if self.sample_rate is None:
            self.sample_rate = _env_float("CKO_SHADOW_SAMPLE_RATE", 1.0)
        if self.promote_windows is None:
            self.promote_windows = _env_int("CKO_SHADOW_PROMOTE_WINDOWS", 3)
        if self.diverge_threshold is None:
            self.diverge_threshold = _env_float("CKO_SHADOW_DIVERGE_THRESHOLD", 0.0)
        if self.latency_ratio is None:
            self.latency_ratio = _env_float("CKO_SHADOW_LATENCY_RATIO", 10.0)
        if self.idle_check_s is None:
            self.idle_check_s = _env_float("CKO_SHADOW_IDLE_S", 2.0)
        if self.queue_depth is None:
            self.queue_depth = _env_int("CKO_SHADOW_QUEUE_DEPTH", 8)
        if self.ring_depth is None:
            self.ring_depth = _env_int("CKO_ROLLOUT_RING", 2)
        self.ring_depth = max(2, int(self.ring_depth))


class EngineRing:
    """Last-known-good (uuid, engine) ring, newest last. Depth ≥ 2 so an
    operator can force-rollback past a promotion that *itself* replaced
    a bad version."""

    def __init__(self, depth: int = 2):
        self._ring: deque[tuple[str | None, object]] = deque(maxlen=max(2, int(depth)))
        self._lock = threading.Lock()

    def push(self, uuid: str | None, engine) -> None:
        if engine is None:
            return
        with self._lock:
            self._ring.append((uuid, engine))

    def pop(self) -> tuple[str | None, object] | None:
        with self._lock:
            return self._ring.pop() if self._ring else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def uuids(self) -> list[str | None]:
        with self._lock:
            return [u for u, _e in self._ring]


@dataclass
class ShadowSample:
    """One mirrored window: the live requests, what the serving engine
    answered, and how long its window took (host+device+decode)."""

    requests: list
    verdicts: list
    serving_s: float
    synthetic: bool = False


class Rollout:
    """One candidate's lifecycle. Thread-safe: the worker, the budget
    watchdog, the mirror hook, and forced aborts all race on ``state``;
    ``_mark`` makes every terminal transition exactly-once."""

    def __init__(self, key: str, uuid: str, baseline, cfg: RolloutConfig):
        self.key = key
        self.uuid = uuid
        self.baseline = baseline
        self.cfg = cfg
        self.engine = None
        self.analysis = None
        self._lock = threading.Lock()
        self.state = ROLLOUT_STAGED
        self.reason = ""
        self.t_start = time.monotonic()
        self.t_end: float | None = None
        # Shadow gating applies only against a proven device baseline:
        # cold/fallback baselines have no healthy device path to mirror,
        # so the candidate promotes directly (old semantics) and the
        # degraded-mode probe warms it after the swap.
        self.shadow_planned = bool(
            baseline is not None and getattr(baseline, "warmed", False)
        ) and int(cfg.promote_windows) > 0
        self.queue: queue.Queue[ShadowSample] = queue.Queue(
            maxsize=max(1, int(cfg.queue_depth))
        )
        self.shadow_windows = 0
        self.clean_windows = 0
        self.shadowed_requests = 0
        self.diverged_requests = 0
        self.dropped_windows = 0
        self.candidate_s = 0.0
        self.serving_s = 0.0

    @property
    def terminal(self) -> bool:
        with self._lock:
            return self.state in _TERMINAL

    def _mark(self, state: str, reason: str = "") -> bool:
        """Transition; returns False if already terminal (lost the race)."""
        with self._lock:
            if self.state in _TERMINAL:
                return False
            self.state = state
            self.reason = reason
            if state in _TERMINAL:
                self.t_end = time.monotonic()
            return True

    def offer(self, sample: ShadowSample) -> bool:
        """Non-blocking mirror enqueue; a full queue drops (and counts) —
        shadow verification must never backpressure serving."""
        try:
            self.queue.put_nowait(sample)
            return True
        except queue.Full:
            with self._lock:
                self.dropped_windows += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uuid": self.uuid,
                "state": self.state,
                "reason": self.reason,
                "shadow_planned": self.shadow_planned,
                "shadow_windows": self.shadow_windows,
                "clean_windows": self.clean_windows,
                "shadowed_requests": self.shadowed_requests,
                "diverged_requests": self.diverged_requests,
                "dropped_windows": self.dropped_windows,
                "candidate_s": round(self.candidate_s, 4),
                "serving_s": round(self.serving_s, 4),
                "wall_s": round(
                    (self.t_end or time.monotonic()) - self.t_start, 2
                ),
            }


class RolloutManager:
    """Coordinates active rollouts across tenants: budgeted staging
    workers, the batcher's shadow mirror routing, aggregate counters, and
    the optional control-plane state callback (``on_state(key, state,
    message)`` — the RuleSet controller mirrors it onto the
    ``RolloutState`` condition)."""

    def __init__(self, config: RolloutConfig | None = None, on_state=None):
        self.config = config if config is not None else RolloutConfig()
        self.on_state = on_state
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._active: dict[str, Rollout] = {}  # tenant key -> live rollout
        self._last: dict[str, Rollout] = {}  # tenant key -> most recent
        self._by_baseline: dict[int, list[Rollout]] = {}
        # Aggregate outcome counters (the cko_rollouts_total gauge).
        self.started = 0
        self.promoted = 0
        self.rolled_back = 0
        self.failed = 0
        # Monotonic shadow counters across ALL rollouts (the per-rollout
        # numbers in ``Rollout.snapshot`` reset with each candidate).
        self.shadow_windows_total = 0
        self.shadow_diverged_total = 0
        self.shadow_dropped_total = 0

    # -- lifecycle ------------------------------------------------------------

    def begin(self, key: str, uuid: str, baseline, build, on_promote, on_fail) -> Rollout:
        """Stage a candidate. ``build()`` → ``(engine, analysis_report)``
        (compile + analysis gate; raises on refusal/compile error) runs
        on a background worker under the compile budget. ``on_promote(r)``
        / ``on_fail(r)`` fire exactly once, on the winning transition."""
        r = Rollout(key, uuid, baseline, self.config)
        with self._lock:
            self._active[key] = r
            self._last[key] = r
            self.started += 1
        self._emit(r, "candidate staged")
        threading.Thread(
            target=self._run,
            args=(r, build, on_promote, on_fail),
            name=f"cko-rollout-{key.replace('/', '-')}",
            daemon=True,
        ).start()
        return r

    def active(self, key: str) -> Rollout | None:
        with self._lock:
            return self._active.get(key)

    def abort(self, key: str, reason: str) -> bool:
        """Terminate an in-flight rollout (forced rollback, supersession).
        The worker observes the terminal state and discards the
        candidate; the outcome counts as rolled_back (failed if it never
        reached shadowing)."""
        with self._lock:
            r = self._active.get(key)
        if r is None:
            return False
        was_staged = r.state == ROLLOUT_STAGED
        marked = r._mark(
            ROLLOUT_FAILED if was_staged else ROLLOUT_ROLLED_BACK, reason
        )
        if marked:
            self._finish(r)
        return marked

    def stop(self) -> None:
        self._stop.set()

    # -- the staging worker ---------------------------------------------------

    def _run(self, r: Rollout, build, on_promote, on_fail) -> None:
        budget = float(r.cfg.compile_budget_s)
        done = threading.Event()

        def _watchdog():
            # The budget is enforced from OUTSIDE the compile: Python
            # cannot interrupt an XLA compile (or an injected stall), so
            # a blown budget records the failure immediately — polls and
            # serving never wait — and the still-running worker discards
            # its result when it eventually finishes.
            if not done.wait(budget) and r._mark(
                ROLLOUT_FAILED, f"compile budget {budget:g}s exceeded"
            ):
                log.error(
                    "rollout candidate blew its compile budget; serving "
                    "engine untouched",
                    None,
                    key=r.key,
                    uuid=r.uuid,
                    budget_s=budget,
                )
                self._finish(r, on_fail)

        threading.Thread(
            target=_watchdog, name=f"cko-rollout-budget-{id(r):x}", daemon=True
        ).start()
        try:
            engine, report = build()
            r.engine, r.analysis = engine, report
            if r.shadow_planned:
                # AOT prewarm + one canary dispatch: the candidate's
                # executables compile HERE, inside the budget, and the
                # device path is proven before any live window mirrors
                # through it. CKO_FAULT_COMPILE_STALL_S /
                # CKO_FAULT_DEVICE_ERROR_RATE fire on this dispatch
                # exactly as they would on a real first dispatch.
                prewarm = getattr(engine, "prewarm", None)
                if prewarm is not None:
                    prewarm([warmup_request()])
                engine.collect(engine.prepare([warmup_request()]))
        except Exception as err:
            done.set()
            if r._mark(ROLLOUT_FAILED, f"{type(err).__name__}: {err}"):
                log.error("rollout candidate failed to stage", err, key=r.key, uuid=r.uuid)
                self._finish(r, on_fail)
            return
        done.set()
        if not r._mark(ROLLOUT_SHADOWING):
            return  # budget blew (or forced abort) while compiling: discard
        if not r.shadow_planned:
            # No healthy device baseline to mirror against (cold/fallback
            # serving, or shadowing disabled): promote directly — the old
            # swap semantics, minus the poll-thread compile stall.
            if r._mark(ROLLOUT_PROMOTED, "direct (no promoted baseline to shadow against)"):
                self._finish(r, on_promote)
            return
        self._emit(r, "shadow verification started")
        self._register(r)
        try:
            self._shadow_loop(r, on_promote, on_fail)
        finally:
            self._deregister(r)

    # -- shadow verification --------------------------------------------------

    def _register(self, r: Rollout) -> None:
        with self._lock:
            self._by_baseline.setdefault(id(r.baseline), []).append(r)

    def _deregister(self, r: Rollout) -> None:
        with self._lock:
            lst = self._by_baseline.get(id(r.baseline), [])
            if r in lst:
                lst.remove(r)
            if not lst:
                self._by_baseline.pop(id(r.baseline), None)

    def wants_window(self, engine) -> bool:
        """Batcher hook (``MicroBatcher.window_wanted``): True only when a
        rollout is actively shadowing against this serving engine. Lets
        blob windows skip request materialization when nobody is
        listening — the async zero-copy path stays zero-copy."""
        with self._lock:
            return bool(self._by_baseline.get(id(engine)))

    def mirror_window(self, engine, requests, verdicts, serving_s: float) -> None:
        """Batcher hook (``MicroBatcher.on_window``): offer a collected
        window to every rollout shadowing against this serving engine.
        O(1) dict probe when no rollout is active — the hot path never
        pays for the subsystem."""
        with self._lock:
            rollouts = list(self._by_baseline.get(id(engine), ()))
        for r in rollouts:
            rate = float(r.cfg.sample_rate)
            if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
                continue
            if not r.offer(ShadowSample(list(requests), list(verdicts), serving_s)):
                with self._lock:
                    self.shadow_dropped_total += 1

    def _idle_sample(self, r: Rollout) -> ShadowSample | None:
        """Idle self-check: run the canonical warmup canary through the
        BASELINE (its signature is prewarmed on both engines — zero
        compiles) so shadowing converges on idle sidecars too. A failing
        baseline is not the candidate's fault: skip and keep waiting."""
        canary = [warmup_request()]
        t0 = time.perf_counter()
        try:
            verdicts = r.baseline.collect(r.baseline.prepare(canary))
        except Exception:
            return None
        return ShadowSample(
            canary, verdicts, time.perf_counter() - t0, synthetic=True
        )

    def _shadow_loop(self, r: Rollout, on_promote, on_fail) -> None:
        while not r.terminal and not self._stop.is_set():
            try:
                sample = r.queue.get(timeout=float(r.cfg.idle_check_s))
            except queue.Empty:
                sample = self._idle_sample(r)
                if sample is None:
                    continue
            if r.terminal:
                return
            self._shadow_one(r, sample, on_promote, on_fail)

    def _shadow_one(self, r: Rollout, sample: ShadowSample, on_promote, on_fail) -> None:
        from ..engine.compile_cache import EXEC_CACHE
        from ..testing.faults import injected_shadow_diverge

        misses_before = EXEC_CACHE.snapshot()[1]
        t0 = time.perf_counter()
        try:
            candidate = r.engine.collect(r.engine.prepare(sample.requests))
        except Exception as err:
            # Candidate device faults roll THIS candidate back; they are
            # invisible to the serving circuit breaker (shadow evaluation
            # never rides the batcher).
            if r._mark(ROLLOUT_ROLLED_BACK, f"candidate device fault: {type(err).__name__}: {err}"):
                log.error("rollout candidate faulted during shadowing", err, key=r.key, uuid=r.uuid)
                self._finish(r, on_fail)
            return
        cand_s = time.perf_counter() - t0
        # A live window whose shape signature the candidate had not seen
        # yet pays a one-time XLA compile inside this eval. That is
        # cold-start cost (amortized the moment it lands in the shared
        # executable cache), not a steady-state regression — excluding
        # such windows from the latency totals keeps the comparison
        # honest. Verdict comparison still counts them.
        warmup = EXEC_CACHE.snapshot()[1] > misses_before
        diverged = sum(
            1
            for a, b in zip(sample.verdicts, candidate)
            if verdict_tuple(a) != verdict_tuple(b)
        )
        if injected_shadow_diverge():
            diverged = max(diverged, len(sample.requests))
        with self._lock:
            self.shadow_windows_total += 1
            self.shadow_diverged_total += diverged
        with r._lock:
            r.shadow_windows += 1
            r.shadowed_requests += len(sample.requests)
            r.diverged_requests += diverged
            if not warmup:
                r.candidate_s += cand_s
                r.serving_s += sample.serving_s
            if diverged == 0:
                r.clean_windows += 1
            div_rate = r.diverged_requests / max(1, r.shadowed_requests)
            clean, windows = r.clean_windows, r.shadow_windows
            cand_total, serve_total = r.candidate_s, r.serving_s
        if r.diverged_requests > 0 and div_rate > float(r.cfg.diverge_threshold):
            if r._mark(
                ROLLOUT_ROLLED_BACK,
                f"verdict divergence {div_rate:.3f} over threshold "
                f"{float(r.cfg.diverge_threshold):g} "
                f"({r.diverged_requests}/{r.shadowed_requests} requests)",
            ):
                self._finish(r, on_fail)
            return
        # Promotion counts every shadow window whose CUMULATIVE divergence
        # stayed within the threshold (we did not roll back above), not
        # only zero-divergence windows: with a nonzero threshold — an
        # operator intentionally shipping verdict-changing rules —
        # promotion must not starve on traffic that keeps exercising the
        # changed rules. With the default threshold 0.0 the two
        # definitions coincide (any divergence already rolled back).
        if windows >= int(r.cfg.promote_windows):
            ratio = float(r.cfg.latency_ratio)
            if ratio > 0 and cand_total > ratio * max(serve_total, 1e-9):
                if r._mark(
                    ROLLOUT_ROLLED_BACK,
                    f"latency regression: candidate {cand_total:.4f}s vs "
                    f"serving {serve_total:.4f}s over {ratio:g}x budget",
                ):
                    self._finish(r, on_fail)
                return
            if r._mark(
                ROLLOUT_PROMOTED, f"{windows} shadow windows ({clean} clean)"
            ):
                self._finish(r, on_promote)

    # -- bookkeeping ----------------------------------------------------------

    def _finish(self, r: Rollout, callback=None) -> None:
        with self._lock:
            if self._active.get(r.key) is r:
                del self._active[r.key]
            if r.state == ROLLOUT_PROMOTED:
                self.promoted += 1
            elif r.state == ROLLOUT_ROLLED_BACK:
                self.rolled_back += 1
            elif r.state == ROLLOUT_FAILED:
                self.failed += 1
        if callback is not None:
            try:
                callback(r)
            except Exception as err:  # outcome hooks must not kill the worker
                log.error("rollout outcome hook failed", err, key=r.key)
        self._emit(r, r.reason)
        log.info(
            "rollout " + r.state,
            key=r.key,
            uuid=r.uuid,
            reason=r.reason,
            **{k: v for k, v in r.snapshot().items() if k.endswith("windows")},
        )

    def _emit(self, r: Rollout, message: str) -> None:
        if self.on_state is None:
            return
        try:
            self.on_state(r.key, r.state, message)
        except Exception as err:  # control-plane mirror is a side channel
            log.error("rollout on_state hook failed", err, key=r.key)

    # -- introspection --------------------------------------------------------

    def state_for(self, key: str) -> str:
        with self._lock:
            r = self._active.get(key) or self._last.get(key)
        return r.state if r is not None else ROLLOUT_IDLE

    def state_code(self, key: str) -> int:
        return ROLLOUT_CODES[self.state_for(key)]

    def shadow_totals(self) -> dict:
        """Monotonic shadow counters across every rollout this process
        ever ran (the ``cko_rollout_shadow_*_total`` gauges)."""
        with self._lock:
            return {
                "windows": self.shadow_windows_total,
                "diverged_requests": self.shadow_diverged_total,
                "dropped_windows": self.shadow_dropped_total,
            }

    def stats(self) -> dict:
        with self._lock:
            last = {k: r.snapshot() for k, r in self._last.items()}
            counts = {
                "started": self.started,
                "promoted": self.promoted,
                "rolled_back": self.rolled_back,
                "failed": self.failed,
            }
        return {
            **counts,
            "shadow": self.shadow_totals(),
            "config": {
                "compile_budget_s": self.config.compile_budget_s,
                "sample_rate": self.config.sample_rate,
                "promote_windows": self.config.promote_windows,
                "diverge_threshold": self.config.diverge_threshold,
                "latency_ratio": self.config.latency_ratio,
                "idle_check_s": self.config.idle_check_s,
                "ring_depth": self.config.ring_depth,
            },
            "rollouts": last,
        }
