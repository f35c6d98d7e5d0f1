"""Trace-driven adaptive scheduler: retune the batching
knobs against a latency SLO.

Every batching knob used to be static: ``max_batch_delay_ms``, pipeline
depth, and the shed thresholds were chosen at boot and held through both
idle mornings and bodied floods. The flight recorder already measures
what those knobs trade off — the stage histograms (`BatcherStats`
step/host/device samples) carry the live p99 — so the ``cko-sched``
thread closes the loop: **small windows when idle, deep pipelining under
load**, generalizing the dispatch watchdog's warmed-p99 auto-deadline
pattern (batcher._window_deadline_for) from one knob to the whole
scheduler.

The controller is deliberately boring, because a clever one could
oscillate the pipeline into the breaker:

* **Two axes, SLO wins.** Queue occupancy decides the throughput
  direction (grow windows/depth when backlogged, shrink when idle); the
  observed p99 against ``CKO_SLO_P99_MS`` overrides it (persistently
  over-SLO → back off regardless of backlog).
* **Hysteresis.** A direction must hold for ``HYSTERESIS_TICKS``
  consecutive ticks before a step is applied, then the streak resets —
  one noisy histogram window never moves a knob.
* **Clamped knob ranges.** Every knob moves multiplicatively inside a
  range derived from its configured base value; the controller can
  never push a knob somewhere the operator couldn't have configured.
* **Warm-up gate.** Below ``MIN_SAMPLES`` step-latency samples the p99
  is noise (and unit tests want an inert controller); the scheduler
  holds.
* **Kill switch.** ``--disable-adaptive`` / ``adaptive_enabled=False``
  keeps every knob exactly where the config put it.

Every decision is observable: ``cko_sched_*`` metrics, the ``scheduler``
block on ``/waf/v1/stats``, and a flight-recorder span per retune (the
``on_retune`` hook — the sidecar stamps a ``sched_retune`` event with
the knob deltas as span args).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from .batcher import LANE_BULK, LANE_INTERACTIVE, LANES, _nearest_rank
from .governor import _env_float, _pick_f
from ..utils import get_logger

log = get_logger("sidecar.scheduler")

DEFAULT_SLO_P99_MS = 50.0
DEFAULT_INTERVAL_S = 0.5
# Consecutive agreeing ticks before a knob moves (then the streak
# resets: a sustained condition steps once per HYSTERESIS_TICKS ticks).
HYSTERESIS_TICKS = 3
# Below this many step-latency samples the controller holds — same gate
# the dispatch watchdog uses before trusting a p99.
MIN_SAMPLES = 20
# p99 is computed over the most recent samples only, so the controller
# reacts to the current regime, not the boot-time compile spikes.
RECENT_WINDOW = 256
# Multiplicative step sizes: gentle enough that clamps + hysteresis
# bound the worst-case ramp, big enough to traverse the range in a few
# steps.
DELAY_STEP = 1.5
BUDGET_STEP = 1.25
# Queue-occupancy thresholds for the throughput axis.
OCC_HIGH = 0.5
OCC_IDLE = 0.05


class AdaptiveScheduler:
    """Feedback controller over a :class:`MicroBatcher`'s live knobs.

    ``queue_budgets`` is the server's per-lane shed-threshold dict,
    shared by reference: admission control reads it on every request,
    the controller nudges it between floods.
    """

    def __init__(
        self,
        batcher,
        *,
        slo_p99_ms: Optional[float] = None,
        interval_s: Optional[float] = None,
        enabled: bool = True,
        queue_budgets: Optional[Dict[str, int]] = None,
        on_retune: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        self.batcher = batcher
        self.enabled = bool(enabled)
        self.slo_p99_ms = _pick_f(slo_p99_ms, "CKO_SLO_P99_MS", DEFAULT_SLO_P99_MS)
        self.interval_s = max(
            0.05,
            _pick_f(interval_s, "CKO_SCHED_INTERVAL_S", DEFAULT_INTERVAL_S),
        )
        self.queue_budgets = queue_budgets if queue_budgets is not None else {}
        self.on_retune = on_retune

        # Clamp ranges anchored on the CONFIGURED base values: the
        # controller explores around the operator's choice, never away
        # from its order of magnitude.
        base_delay_ms = {
            lane: max(0.0, batcher.lane_delay_s[lane] * 1e3) for lane in LANES
        }
        self._base_delay_ms = base_delay_ms
        self.min_delay_ms = {
            lane: max(0.05, base_delay_ms[lane] / 8.0) for lane in LANES
        }
        self.max_delay_ms = {
            lane: max(base_delay_ms[lane] * 8.0, 1.0) for lane in LANES
        }
        self._base_depth = max(1, int(batcher.pipeline_depth))
        self.min_depth = 1
        self.max_depth = max(4, self._base_depth * 4)
        self._base_budgets = dict(self.queue_budgets)
        self.min_budget = {
            lane: max(1, b // 8) for lane, b in self._base_budgets.items()
        }

        # Hysteresis state + decision ring.
        self._direction: Optional[str] = None
        self._streak = 0
        self.retunes = deque(maxlen=64)
        self.retunes_total: Dict[str, int] = {}
        self.ticks = 0
        self.last_p99_ms = 0.0
        self.last_occupancy = 0.0

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Optional deterministic latency override for environments where
        # the env knob is easier to reach than the constructor (smokes).
        self._min_samples = int(_env_float("CKO_SCHED_MIN_SAMPLES", MIN_SAMPLES))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="cko-sched", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as err:  # the controller must never take serving down
                log.error("scheduler tick failed", err)

    # -- the control law ---------------------------------------------------

    def observe(self) -> tuple[float, float, int]:
        """(p99_ms over the recent step-latency window, queue occupancy
        against the shed thresholds, sample count)."""
        lats = list(self.batcher.stats.step_latencies_s)
        samples = len(lats)
        recent = sorted(lats[-RECENT_WINDOW:])
        p99_ms = _nearest_rank(recent, 0.99) * 1e3
        budget = sum(self.queue_budgets.values()) or 1
        pending = self.batcher.pending()
        occupancy = pending / budget
        return p99_ms, occupancy, samples

    def decide(self, p99_ms: float, occupancy: float) -> str:
        """Pure policy: 'relieve' (over SLO — smaller windows, shallower
        pipeline, tighter shed), 'deepen' (backlogged within SLO — bigger
        windows, deeper pipeline), 'shrink' (idle — small windows for
        latency), or 'hold'. The SLO axis wins over the occupancy axis."""
        if self.slo_p99_ms > 0 and p99_ms > self.slo_p99_ms:
            return "relieve"
        if occupancy >= OCC_HIGH:
            return "deepen"
        if occupancy <= OCC_IDLE:
            return "shrink"
        return "hold"

    def tick(self) -> Optional[Dict[str, Any]]:
        """One control iteration; returns the applied retune event, or
        None when held (kill switch, warm-up, hysteresis, or clamps)."""
        if not self.enabled:
            return None
        self.ticks += 1
        p99_ms, occupancy, samples = self.observe()
        self.last_p99_ms = p99_ms
        self.last_occupancy = occupancy
        if samples < self._min_samples:
            return None
        direction = self.decide(p99_ms, occupancy)
        if direction == "hold":
            self._direction, self._streak = None, 0
            return None
        if direction == self._direction:
            self._streak += 1
        else:
            self._direction, self._streak = direction, 1
        if self._streak < HYSTERESIS_TICKS:
            return None
        self._streak = 0
        return self._apply(direction, p99_ms, occupancy)

    # -- knob application --------------------------------------------------

    def _clamp_delay(self, lane: str, ms: float) -> float:
        return min(self.max_delay_ms[lane], max(self.min_delay_ms[lane], ms))

    def _apply(
        self, direction: str, p99_ms: float, occupancy: float
    ) -> Optional[Dict[str, Any]]:
        changes: Dict[str, list] = {}

        def set_delay(lane: str, new_ms: float) -> None:
            old_ms = self.batcher.lane_delay_s[lane] * 1e3
            new_ms = self._clamp_delay(lane, new_ms)
            if abs(new_ms - old_ms) > 1e-9:
                self.batcher.set_lane_delay(lane, new_ms)
                changes[f"delay_ms.{lane}"] = [round(old_ms, 4), round(new_ms, 4)]

        def set_depth(new_depth: int) -> None:
            old = self.batcher.pipeline_depth
            new_depth = min(self.max_depth, max(self.min_depth, new_depth))
            if new_depth != old:
                self.batcher.set_pipeline_depth(new_depth)
                changes["pipeline_depth"] = [old, new_depth]

        def set_budget(lane: str, new_b: int) -> None:
            old = self.queue_budgets.get(lane)
            if old is None:
                return
            base = self._base_budgets.get(lane, old)
            new_b = min(base, max(self.min_budget.get(lane, 1), new_b))
            if new_b != old:
                self.queue_budgets[lane] = new_b
                changes[f"queue_budget.{lane}"] = [old, new_b]

        depth = self.batcher.pipeline_depth
        if direction == "relieve":
            # Over SLO: waiting costs latency we no longer have. Close
            # windows sooner, drain the pipeline shallower, and shed
            # earlier so queueing delay cannot compound.
            for lane in LANES:
                set_delay(lane, self.batcher.lane_delay_s[lane] * 1e3 / DELAY_STEP)
            set_depth(depth - 1)
            for lane in list(self.queue_budgets):
                set_budget(lane, int(self.queue_budgets[lane] / BUDGET_STEP))
        elif direction == "deepen":
            # Backlogged but inside SLO: spend the latency headroom on
            # throughput — bigger windows amortize the device step,
            # deeper pipelining overlaps host assembly with it. The
            # interactive lane keeps its configured delay: its whole
            # point is bounded window-close latency for headers-only
            # traffic, and its windows fill from arrival rate alone.
            set_delay(LANE_BULK, self.batcher.lane_delay_s[LANE_BULK] * 1e3 * DELAY_STEP)
            set_depth(depth + 1)
            for lane in list(self.queue_budgets):
                set_budget(lane, int(self.queue_budgets[lane] * BUDGET_STEP) + 1)
        else:  # shrink (idle)
            # Idle: windows close on the delay timer, so the delay IS
            # the latency floor — walk both lanes back down and relax
            # the shed thresholds to their configured base.
            for lane in LANES:
                set_delay(lane, self.batcher.lane_delay_s[lane] * 1e3 / DELAY_STEP)
            set_depth(depth - 1 if depth > self._base_depth else depth)
            for lane in list(self.queue_budgets):
                set_budget(lane, int(self.queue_budgets[lane] * BUDGET_STEP) + 1)

        if not changes:
            return None
        event = {
            "t": time.time(),
            "direction": direction,
            "p99_ms": round(p99_ms, 3),
            "slo_p99_ms": self.slo_p99_ms,
            "occupancy": round(occupancy, 4),
            "changes": changes,
        }
        self.retunes.append(event)
        for knob in changes:
            self.retunes_total[knob] = self.retunes_total.get(knob, 0) + 1
        if self.on_retune is not None:
            try:
                self.on_retune(event)
            except Exception as err:  # observability is a side channel
                log.error("retune hook failed", err)
        return event

    # -- observability -----------------------------------------------------

    @property
    def retune_count(self) -> int:
        return sum(self.retunes_total.values())

    def stats(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "running": self._thread is not None and self._thread.is_alive(),
            "slo_p99_ms": self.slo_p99_ms,
            "interval_s": self.interval_s,
            "ticks": self.ticks,
            "p99_ms": round(self.last_p99_ms, 3),
            "occupancy": round(self.last_occupancy, 4),
            "lane_delay_ms": {
                lane: round(self.batcher.lane_delay_s[lane] * 1e3, 4)
                for lane in LANES
            },
            "pipeline_depth": self.batcher.pipeline_depth,
            "queue_budgets": dict(self.queue_budgets),
            "retunes_total": dict(self.retunes_total),
            "retunes": list(self.retunes)[-8:],
            "clamps": {
                "delay_ms": {
                    lane: [self.min_delay_ms[lane], self.max_delay_ms[lane]]
                    for lane in LANES
                },
                "pipeline_depth": [self.min_depth, self.max_depth],
                "queue_budget_min": dict(self.min_budget),
            },
        }


__all__ = [
    "AdaptiveScheduler",
    "DEFAULT_SLO_P99_MS",
    "HYSTERESIS_TICKS",
    "MIN_SAMPLES",
    "LANE_BULK",
    "LANE_INTERACTIVE",
]
