"""Rule hot reload: poll the cache server, recompile off the serving path.

Implements the data-plane half of the cache-poll contract the reference
configures into coraza-proxy-wasm (pluginConfig keys
``cache_server_instance`` / ``cache_server_cluster`` /
``rule_reload_interval_seconds``, the reference's Istio engine
controller, lines 96-103; poll loop behavior SURVEY §3.4):

- every ``poll_interval_s``: ``GET /rules/{key}/latest`` → ``{uuid, ts}``;
- uuid unchanged → nothing;
- uuid changed → ``GET /rules/{key}`` → full rules → **staged rollout**
  (docs/ROLLOUT.md): a budgeted background worker compiles the candidate
  (``CKO_COMPILE_BUDGET_S``), the analysis gate runs, the candidate is
  prewarmed, live traffic is shadow-mirrored through it, and only after
  N clean windows does it swap in — with the previous engine pushed onto
  a last-known-good ring for ``POST /waf/v1/rollback``. A blown budget,
  gate refusal, verdict divergence, candidate fault, or latency
  regression leaves the serving engine untouched and records a
  failed/rolled-back rollout. The poll thread NEVER compiles once a
  ruleset is serving.
- first load (nothing serving yet), or no rollout manager wired (tests,
  standalone use): the legacy inline path — compile on this thread,
  gate, atomic swap.

Compile failures keep the previous engine serving (the WASM plugin behaves
the same way: last-loaded rules keep running).

Reload analysis gate (docs/ANALYSIS.md): every successfully compiled
reload is statically analyzed (``analysis.rulelint``) against the ruleset
currently serving. A reload that introduces NEW error-severity findings —
a ReDoS-prone host-path pattern, a duplicate id, a parse regression in an
included file — is refused and the previous engine keeps serving, unless
``CKO_ANALYZE_OVERRIDE=1`` is set. The first load is never gated (there
is no previous ruleset to keep serving; admission-time analysis is the
controller's job) and an analyzer *crash* never blocks a reload.

Poll jitter: every wait is multiplied by a ±20% uniform factor so a fleet
of tenant sidecars that all saw a cache-server outage clear does not
re-synchronize into a thundering herd of polls (and recompiles) on the
same beat.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.error
import urllib.request

from ..analysis.findings import AnalysisReport
from ..engine.waf import WafEngine
from ..utils import get_logger
from .rollout import EngineRing, RolloutManager, RolloutRefused

log = get_logger("sidecar.reloader")

ANALYZE_OVERRIDE_ENV = "CKO_ANALYZE_OVERRIDE"
# A failed/rolled-back rollout latches its uuid so the poller does not
# re-compile the same bad document every interval. 0 (default) keeps the
# latch until a NEW version is published; >0 retries after that many
# seconds (for transient causes — a device fault storm that cleared).
ROLLOUT_RETRY_ENV = "CKO_ROLLOUT_RETRY_S"

DEFAULT_POLL_INTERVAL_S = 15.0
# Failure backoff: after a failed poll the next attempt comes quickly and
# backs off exponentially up to the normal interval — a transient cache
# outage must not delay the FIRST ruleset load by a whole poll period
# (fail-closed sidecars answer 503 until it lands).
BACKOFF_BASE_S = 0.5
# ±20% poll jitter (thundering-herd decorrelation across a tenant fleet).
JITTER_FRACTION = 0.2


class RuleReloader:
    """Background poller owning the current (engine, uuid) pair."""

    def __init__(
        self,
        cache_base_url: str,
        instance_key: str,
        poll_interval_s: float = DEFAULT_POLL_INTERVAL_S,
        engine_factory=WafEngine,
        on_swap=None,
        rollout: RolloutManager | None = None,
        on_persist=None,
    ):
        # on_swap(engine): called after every atomic engine swap — the
        # sidecar uses it to kick background device promotion for the
        # fresh engine (degraded-mode serving) without waiting for the
        # first request to route.
        self._on_swap = on_swap
        # on_persist(): called after every swap/promote/rollback so the
        # sidecar can write its durable serving-state snapshot
        # (sidecar/state_store.py) — crash-safe warm restart depends on
        # the snapshot tracking every serving transition, not a timer.
        self._on_persist = on_persist
        self.cache_base_url = cache_base_url.rstrip("/")
        self.instance_key = instance_key.strip("/")
        self.poll_interval_s = poll_interval_s
        self._engine_factory = engine_factory
        self._engine: WafEngine | None = None
        self._uuid: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._loaded_once = threading.Event()
        self.reloads = 0
        self.failed_reloads = 0
        self.polls = 0
        # Cache-poll health (degraded-mode observability): total failed
        # fetches and the current consecutive-failure streak driving the
        # retry backoff.
        self.poll_failures = 0
        self.consecutive_poll_failures = 0
        # Static-analysis reload gate: the serving ruleset's report (None
        # until first analyzed) and how many reloads the gate refused.
        # The refused uuid is latched so a rejected document is not
        # re-fetched/re-compiled/re-analyzed every poll interval; setting
        # the override env or publishing a new version unlatches.
        self.analysis: AnalysisReport | None = None
        self.analyze_rejected = 0
        self._rejected_uuid: str | None = None
        # Staged rollout (docs/ROLLOUT.md): manager (None = legacy inline
        # reloads), last-known-good engine ring for forced rollback, and
        # the failed-rollout uuid latch.
        self._rollout_mgr = rollout
        ring_depth = rollout.config.ring_depth if rollout is not None else 2
        self.ring = EngineRing(ring_depth)
        self.rollbacks_forced = 0
        self._swap_lock = threading.Lock()
        self._rollout_latched: dict[str, float] = {}
        # Durable-state support (docs/RECOVERY.md): ruleset TEXT by uuid
        # for the serving engine, ring entries, and any actively staging
        # candidate. Text is the durable form of an engine — snapshots
        # persist it, restore recompiles it (dedup + compile caches make
        # that cheap). Pruned on every swap. Seeded engines (tests,
        # static rules) have no text and are simply not persisted.
        self._text_by_uuid: dict[str, str] = {}
        # True when this reloader's serving state came from a disk
        # snapshot rather than a cache poll (the /stats recovery block).
        self.restored = False
        # Bumped by every forced rollback. A rollout captures the epoch
        # when it stages; its promotion swap is honored only if no forced
        # rollback intervened — closing the race where a candidate wins
        # its terminal transition just before the operator's abort and
        # would otherwise swap in anyway, silently overriding them.
        self._swap_epoch = 0

    # -- public --------------------------------------------------------------

    @property
    def engine(self) -> WafEngine | None:
        return self._engine

    @property
    def current_uuid(self) -> str | None:
        return self._uuid

    def seed(
        self, engine: WafEngine, uuid: str | None = None, rules: str | None = None
    ) -> None:
        """Install a pre-built engine (static rules / tests) through the same
        swap invariant the poll path uses. Passing the ruleset ``rules``
        text makes the seeded engine durable (snapshot-restorable)."""
        self._engine = engine
        self._uuid = uuid
        if uuid and rules:
            self._text_by_uuid[uuid] = rules
        self._loaded_once.set()

    def start(self) -> None:
        # First load happens on the poll thread, never the caller: a large
        # ruleset compile must not delay the HTTP listener (fail-open and
        # probe semantics depend on the server being up).
        self._thread = threading.Thread(target=self._run, name="reloader", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def wait_loaded(self, timeout_s: float) -> bool:
        return self._loaded_once.wait(timeout=timeout_s)

    def next_wait_s(self) -> float:
        """Sleep until the next poll attempt: the normal interval when
        healthy, exponential backoff (BACKOFF_BASE_S · 2^k, capped at the
        interval) while the cache server is failing — times a ±20%
        jitter factor, so a fleet whose cache outage just cleared fans
        its polls out instead of stampeding the server on one beat."""
        k = self.consecutive_poll_failures
        if k <= 0:
            base = self.poll_interval_s
        else:
            # Cap the exponent: 2**k overflows float conversion once a
            # long outage pushes k past ~1024, killing the poll thread.
            base = min(self.poll_interval_s, BACKOFF_BASE_S * 2.0 ** min(k - 1, 60))
        return base * random.uniform(1.0 - JITTER_FRACTION, 1.0 + JITTER_FRACTION)

    def _poll_failed(self) -> None:
        self.poll_failures += 1
        self.consecutive_poll_failures += 1

    def poll_once(self) -> bool:
        """One poll step; returns True if a new ruleset was swapped in.
        With a rollout manager wired and a ruleset already serving, a new
        version only *stages* here (False) — the swap happens when the
        candidate's shadow verification promotes it."""
        self.polls += 1
        try:
            latest = self._get_json(f"/rules/{self.instance_key}/latest")
        except (urllib.error.URLError, ValueError, OSError) as err:
            self._poll_failed()
            log.debug(
                "cache poll failed",
                key=self.instance_key,
                error=str(err),
                consecutive=self.consecutive_poll_failures,
                retry_in_s=round(self.next_wait_s(), 2),
            )
            return False
        self.consecutive_poll_failures = 0
        uuid = latest.get("uuid")
        if not uuid or uuid == self._uuid:
            return False
        if uuid == self._rejected_uuid and os.environ.get(ANALYZE_OVERRIDE_ENV) != "1":
            return False  # already refused by the analysis gate; don't re-compile
        if self._is_rollout_latched(uuid):
            return False  # rollout failed/rolled back; wait for a new version
        mgr = self._rollout_mgr
        if mgr is not None:
            active = mgr.active(self.instance_key)
            if active is not None and active.uuid == uuid:
                return False  # this version is already staging/shadowing
        try:
            entry = self._get_json(f"/rules/{self.instance_key}")
        except (urllib.error.URLError, ValueError, OSError) as err:
            self._poll_failed()
            log.info("rules fetch failed", key=self.instance_key, error=str(err))
            return False
        rules = entry.get("rules", "")
        self._remember_text(uuid, rules)
        if mgr is not None and self._engine is not None:
            # A newer version supersedes any in-flight candidate: the
            # operator's latest intent wins; the old candidate is
            # discarded without ever having served. Aborted only AFTER
            # the replacement's rules fetched successfully — a transient
            # fetch failure must not discard a healthy candidate for
            # nothing.
            if mgr.active(self.instance_key) is not None:
                mgr.abort(self.instance_key, f"superseded by {uuid}")
            # Staged rollout: compile + gate + prewarm + shadow-verify in
            # a budgeted background worker. This poll thread returns NOW —
            # a minutes-long candidate compile can never stall polling,
            # and the serving engine is untouched until promotion.
            epoch = self._swap_epoch
            mgr.begin(
                self.instance_key,
                uuid,
                self._engine,
                build=lambda: self._build_candidate(rules, uuid),
                on_promote=lambda r: self._rollout_promoted(r, epoch),
                on_fail=self._rollout_failed,
            )
            return False
        # Legacy inline path: first load (nothing serving — there is no
        # traffic to protect and no baseline to shadow against) or no
        # rollout manager wired.
        try:
            engine = self._engine_factory(rules)
        except Exception as err:  # invalid rules: keep serving previous engine
            self.failed_reloads += 1
            log.error("rule compile failed; keeping previous ruleset", err, uuid=uuid)
            return False
        report = self._analyze(rules, engine)
        if not self._admit(report, uuid):
            self.failed_reloads += 1
            self.analyze_rejected += 1
            self._rejected_uuid = uuid
            return False
        self._swap(uuid, engine, report)
        return True

    # -- staged rollout (docs/ROLLOUT.md) ------------------------------------

    def _build_candidate(self, rules: str, uuid: str):
        """Rollout worker's build step: compile + analysis gate, off the
        poll thread. Raises :class:`RolloutRefused` on a gate refusal
        (latching the uuid exactly like the inline path) and lets
        compile errors propagate — either way the rollout records a
        failure and the serving engine is untouched."""
        engine = self._engine_factory(rules)
        report = self._analyze(rules, engine)
        if not self._admit(report, uuid):
            self.analyze_rejected += 1
            self._rejected_uuid = uuid
            raise RolloutRefused(
                "analysis gate refused candidate (new error-severity findings)"
            )
        return engine, report

    def _rollout_promoted(self, r, epoch: int) -> None:
        self._swap(r.uuid, r.engine, r.analysis, epoch=epoch)

    def _rollout_failed(self, r) -> None:
        self.failed_reloads += 1
        # An analysis-gate refusal is already latched as _rejected_uuid,
        # which honors CKO_ANALYZE_OVERRIDE=1 — rollout-latching it too
        # would make the documented override silently inert (the rollout
        # latch has no override escape by design).
        if r.uuid != self._rejected_uuid:
            self._latch_rollout(r.uuid)

    def _latch_rollout(self, uuid: str | None) -> None:
        if uuid:
            self._rollout_latched[uuid] = time.monotonic()

    def _is_rollout_latched(self, uuid: str) -> bool:
        t = self._rollout_latched.get(uuid)
        if t is None:
            return False
        try:
            retry_s = float(os.environ.get(ROLLOUT_RETRY_ENV, "0") or 0)
        except ValueError:
            retry_s = 0.0
        if retry_s > 0 and time.monotonic() - t >= retry_s:
            self._rollout_latched.pop(uuid, None)
            return False
        return True

    def _swap(
        self, uuid: str | None, engine: WafEngine, report, epoch: int | None = None
    ) -> None:
        """THE swap invariant: push the previous engine onto the
        last-known-good ring, then atomically install the new pair. Used
        by the inline path and rollout promotion alike; a promotion swap
        carries its staging-time epoch and is DISCARDED if a forced
        rollback bumped it since — the operator's decision wins."""
        with self._swap_lock:
            if epoch is not None and epoch != self._swap_epoch:
                self._latch_rollout(uuid)
                log.info(
                    "promotion discarded: forced rollback intervened",
                    key=self.instance_key,
                    uuid=uuid,
                )
                return
            if self._engine is not None:
                self.ring.push(self._uuid, self._engine)
            if report is not None:
                self.analysis = report
            # else: analyzer crashed — keep the previous baseline so the
            # next reload still compares against real findings (an empty
            # baseline would read every pre-existing error as "new" and
            # refuse a fix).
            self._rejected_uuid = None
            self._engine = engine  # atomic swap; next batch window uses it
            self._uuid = uuid
            self.reloads += 1
            self._prune_text()
        self._loaded_once.set()
        if self._on_swap is not None:
            try:
                self._on_swap(engine)
            except Exception as err:  # promotion kick must not break reload
                log.error("on_swap hook failed", err)
        log.info(
            "ruleset reloaded",
            key=self.instance_key,
            uuid=uuid,
            rules=engine.compiled.n_rules,
            groups=engine.compiled.n_groups,
        )
        self._persist()

    def force_rollback(self) -> dict | None:
        """Operator-forced rollback (``POST /waf/v1/rollback``): abort any
        in-flight rollout, swap serving back to the ring's most recent
        last-known-good engine, and latch the rolled-back-from uuid so
        the next poll does not immediately re-stage it. Returns the swap
        summary, or None when the ring is empty."""
        if self._rollout_mgr is not None:
            active = self._rollout_mgr.active(self.instance_key)
            if active is not None:
                self._latch_rollout(active.uuid)
            self._rollout_mgr.abort(self.instance_key, "forced rollback")
        with self._swap_lock:
            entry = self.ring.pop()
            if entry is None:
                return None
            bad_uuid = self._uuid
            prev_uuid, prev_engine = entry
            self._engine = prev_engine
            self._uuid = prev_uuid
            self.rollbacks_forced += 1
            self._latch_rollout(bad_uuid)
            # Cancel any promotion swap still in flight for a candidate
            # staged before this rollback (abort may have lost the race
            # to its terminal transition).
            self._swap_epoch += 1
        if self._on_swap is not None:
            try:
                self._on_swap(prev_engine)
            except Exception as err:
                log.error("on_swap hook failed", err)
        log.info(
            "forced rollback to last-known-good",
            key=self.instance_key,
            rolled_back_from=bad_uuid,
            rolled_back_to=prev_uuid,
        )
        self._persist()
        return {
            "tenant": self.instance_key,
            "rolled_back_from": bad_uuid,
            "rolled_back_to": prev_uuid,
            "ring_remaining": len(self.ring),
        }

    # -- durable serving state (docs/RECOVERY.md) ----------------------------

    def _remember_text(self, uuid: str | None, rules: str) -> None:
        # Under _swap_lock: _prune_text (rollout promotion thread) swaps
        # the dict object; an unlocked write here could land in the old
        # one and silently vanish from the next snapshot.
        if uuid and rules:
            with self._swap_lock:
                self._text_by_uuid[uuid] = rules

    def _prune_text(self) -> None:
        """Keep only the texts the snapshot can reference: serving, ring,
        and any actively staging candidate. Called under ``_swap_lock``."""
        keep = {u for u in [self._uuid, *self.ring.uuids()] if u}
        if self._rollout_mgr is not None:
            active = self._rollout_mgr.active(self.instance_key)
            if active is not None and active.uuid:
                keep.add(active.uuid)
        self._text_by_uuid = {
            u: t for u, t in self._text_by_uuid.items() if u in keep
        }

    def _persist(self) -> None:
        """Kick the sidecar's snapshot write; a failing persist hook must
        never break the swap that triggered it."""
        if self._on_persist is None:
            return
        try:
            self._on_persist()
        except Exception as err:
            log.error("on_persist hook failed", err)

    def snapshot(self) -> dict | None:
        """Durable view of this tenant's serving state: ruleset TEXT for
        the serving engine and every ring entry, plus the rollout latches
        and the analysis-rejected uuid. Returns None when nothing
        persistable is serving (no engine, or a seeded engine whose text
        was never provided)."""
        with self._swap_lock:
            if self._engine is None or not self._uuid:
                return None
            rules = self._text_by_uuid.get(self._uuid)
            if not rules:
                return None
            ring = []
            for ring_uuid in self.ring.uuids():  # oldest -> newest
                text = self._text_by_uuid.get(ring_uuid or "")
                if ring_uuid and text:
                    ring.append({"uuid": ring_uuid, "rules": text})
            return {
                "uuid": self._uuid,
                "rules": rules,
                "ring": ring,
                "latched": sorted(self._rollout_latched),
                "rejected_uuid": self._rejected_uuid,
            }

    def restore(self, snap: dict) -> bool:
        """Rebuild serving state from a disk snapshot BEFORE the first
        cache poll: compile the serving ruleset (and the LKG ring's
        entries, oldest first, so ``POST /waf/v1/rollback`` behaves
        identically after a restart), re-run the analysis baseline, and
        re-latch failed-rollout uuids. Returns False on any failure —
        the caller then cold-starts through the normal poll path. The
        restored uuid reconciles against the next successful poll for
        free: ``poll_once`` short-circuits on an unchanged uuid and
        stages anything newer through the standard rollout pipeline."""
        uuid = snap.get("uuid")
        rules = snap.get("rules")
        if not uuid or not isinstance(rules, str) or not rules:
            return False
        try:
            engine = self._engine_factory(rules)
        except Exception as err:
            log.error("snapshot restore compile failed", err, uuid=uuid)
            return False
        report = self._analyze(rules, engine)
        ring_entries = []
        for entry in snap.get("ring") or []:
            if not isinstance(entry, dict):
                continue
            ring_uuid, text = entry.get("uuid"), entry.get("rules")
            if not ring_uuid or not isinstance(text, str) or not text:
                continue
            try:
                ring_entries.append((ring_uuid, self._engine_factory(text), text))
            except Exception as err:
                # A ring entry that no longer compiles shrinks the ring;
                # it must not block restoring the serving engine.
                log.error("ring entry restore failed", err, uuid=ring_uuid)
        with self._swap_lock:
            for ring_uuid, ring_engine, text in ring_entries:
                self.ring.push(ring_uuid, ring_engine)
                self._text_by_uuid[ring_uuid] = text
            self._engine = engine
            self._uuid = uuid
            self._text_by_uuid[uuid] = rules
            if report is not None:
                self.analysis = report
            rejected = snap.get("rejected_uuid")
            self._rejected_uuid = rejected if isinstance(rejected, str) else None
            now = time.monotonic()
            for latched in snap.get("latched") or []:
                if isinstance(latched, str) and latched:
                    self._rollout_latched[latched] = now
            self.restored = True
        self._loaded_once.set()
        if self._on_swap is not None:
            try:
                self._on_swap(engine)  # kick background device promotion
            except Exception as err:
                log.error("on_swap hook failed", err)
        log.info(
            "serving state restored from snapshot",
            key=self.instance_key,
            uuid=uuid,
            ring=len(ring_entries),
            rules=engine.compiled.n_rules,
        )
        return True

    # -- internals -----------------------------------------------------------

    def _analyze(self, rules: str, engine: WafEngine) -> AnalysisReport | None:
        """Static analysis of a freshly compiled ruleset, reusing the
        engine's compiled IR (no second compile). An analyzer crash must
        never block a reload — it degrades to 'not analyzed' (None)."""
        try:
            from ..analysis.rulelint import analyze_document

            return analyze_document(rules, engine.compiled)
        except Exception as err:
            log.error("ruleset analysis failed; reload not gated", err)
            return None

    def _admit(self, report: AnalysisReport | None, uuid: str | None) -> bool:
        """The reload gate: refuse a swap that introduces NEW error-severity
        findings relative to the serving ruleset (docs/ANALYSIS.md). First
        load (nothing serving yet) and analyzer failures always admit;
        ``CKO_ANALYZE_OVERRIDE=1`` overrides a refusal."""
        if report is None or self._engine is None:
            return True
        previous = self.analysis.error_keys() if self.analysis is not None else set()
        new_errors = [f for f in report.errors if f.key not in previous]
        if not new_errors:
            return True
        if os.environ.get(ANALYZE_OVERRIDE_ENV) == "1":
            log.info(
                "reload has new error findings; admitted by override",
                key=self.instance_key,
                uuid=uuid,
                errors=len(new_errors),
            )
            return True
        log.error(
            "reload refused: new error-severity analysis findings "
            f"(set {ANALYZE_OVERRIDE_ENV}=1 to override)",
            key=self.instance_key,
            uuid=uuid,
            findings=[f.render() for f in new_errors[:5]],
        )
        return False

    def _get_json(self, path: str) -> dict:
        from ..testing.faults import maybe_cache_outage

        maybe_cache_outage()
        with urllib.request.urlopen(self.cache_base_url + path, timeout=10) as resp:
            return json.loads(resp.read().decode())

    def _run(self) -> None:
        self.poll_once()  # eager first load, off the caller's thread
        while not self._stop.wait(self.next_wait_s()):
            self.poll_once()
