"""Multi-tenant ruleset management for the tpu-engine sidecar.

BASELINE config #5 is "32 namespaced RuleSets hot-reloading under
sustained 100k QPS": one sidecar process keeps N compiled rulesets
resident (each with its own device tables) and routes every request to
its tenant's engine. Reload polling is shared: one background thread
sweeps all tenants round-robin each interval, so N tenants cost N cheap
``/latest`` probes per period, and recompiles happen off the serving
path exactly like the single-tenant reloader (``reloader.py``).

Tenant selection contract (the multi-tenant analog of the reference's
per-Engine pluginConfig ``cache_server_instance``): filter-mode requests
carry ``X-Waf-Tenant: namespace/name``; bulk requests may set
``"tenant"`` per serialized request. Unknown tenants behave like an
unloaded ruleset (failure policy applies).
"""

from __future__ import annotations

import hashlib
import threading
import weakref

from ..engine.waf import WafEngine
from ..utils import get_logger
from .reloader import DEFAULT_POLL_INTERVAL_S, RuleReloader

log = get_logger("sidecar.tenants")

TENANT_HEADER = "x-waf-tenant"


class SharedEngineFactory:
    """Dedupe resident engines by compiled-ruleset content hash.

    Tenants fork few base policies (bench config 5's shape: 32 tenants
    over 4 distinct rulesets), and an engine's device tables + executable
    signatures are a pure function of its ruleset text — so N tenants on
    M distinct rulesets must hold M engines, not N. Keying by tenant id
    (the old behavior) held N full sets of device tables and sent N
    compile storms through XLA on rollout.

    Entries are weak: when every tenant's reloader has moved off an
    engine, it (and its device tables) is collectable. Thread-safe; the
    slow compile runs outside the lock, so two tenants racing the same
    fresh ruleset may compile twice — the loser is dropped and its
    executables were shared via the executable cache anyway."""

    def __init__(self, factory=WafEngine):
        self._factory = factory
        self._by_hash: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
        self._lock = threading.Lock()
        self.dedup_hits = 0

    def __call__(self, rules):
        if not isinstance(rules, (str, bytes)):
            return self._factory(rules)  # pre-compiled object: no text key
        raw = rules.encode("utf-8", "surrogatepass") if isinstance(rules, str) else rules
        key = hashlib.sha256(raw).hexdigest()
        with self._lock:
            engine = self._by_hash.get(key)
            if engine is not None:
                self.dedup_hits += 1
                return engine
        engine = self._factory(rules)  # compile outside the lock (slow)
        with self._lock:
            resident = self._by_hash.get(key)
            if resident is not None:
                self.dedup_hits += 1
                return resident
            self._by_hash[key] = engine
            return engine

    @property
    def resident(self) -> int:
        with self._lock:
            return len(self._by_hash)


class TenantManager:
    """Owns one RuleReloader per tenant key; polls them on a shared thread."""

    def __init__(
        self,
        cache_base_url: str,
        tenant_keys: list[str],
        poll_interval_s: float = DEFAULT_POLL_INTERVAL_S,
        engine_factory=WafEngine,
        on_swap=None,
        rollout=None,
        on_persist=None,
    ):
        self.cache_base_url = cache_base_url
        self.poll_interval_s = poll_interval_s
        self._reloaders: dict[str, RuleReloader] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Content-hash dedupe wraps whatever factory the caller supplied:
        # tenants polling identical ruleset text share ONE engine object
        # (and therefore one set of device tables + executables).
        self._engine_factory = (
            engine_factory
            if isinstance(engine_factory, SharedEngineFactory)
            else SharedEngineFactory(engine_factory)
        )
        self._on_swap = on_swap  # forwarded to every tenant's reloader
        self._on_persist = on_persist  # likewise (durable-state snapshot)
        # Staged-rollout manager (sidecar/rollout.py), shared across
        # tenants: one shadow-mirror router and one set of outcome
        # counters; each tenant's reloader stages its own candidates.
        self._rollout = rollout
        for key in tenant_keys:
            self.add(key)
        # Normalized like the reloader keys, so the two never diverge.
        self.default_tenant = tenant_keys[0].strip("/") if tenant_keys else None

    def add(self, key: str) -> None:
        key = key.strip("/")
        with self._lock:
            if key in self._reloaders:
                return
            self._reloaders[key] = RuleReloader(
                cache_base_url=self.cache_base_url,
                instance_key=key,
                poll_interval_s=self.poll_interval_s,
                engine_factory=self._engine_factory,
                on_swap=self._on_swap,
                rollout=self._rollout,
                on_persist=self._on_persist,
            )

    def seed(self, key: str, engine: WafEngine) -> None:
        self.add(key)
        with self._lock:
            self._reloaders[key.strip("/")].seed(engine)

    @property
    def tenants(self) -> list[str]:
        with self._lock:
            return list(self._reloaders)

    def engine_for(self, key: str | None) -> WafEngine | None:
        key = (key or self.default_tenant or "").strip("/")
        with self._lock:
            reloader = self._reloaders.get(key)
        return reloader.engine if reloader is not None else None

    def ruleset_uuid_for(self, engine) -> str | None:
        """The ruleset uuid some tenant currently serves ``engine``
        under, or None (seeded/unknown engines). Cache-key component for
        the verdict cache (sidecar/verdict_cache.py); O(tenants) scan,
        memoized per window by the batcher."""
        if engine is None:
            return None
        with self._lock:
            reloaders = list(self._reloaders.values())
        for r in reloaders:
            if r.engine is engine:
                return r.current_uuid
        return None

    def any_loaded(self) -> bool:
        with self._lock:
            reloaders = list(self._reloaders.values())
        return any(r.engine is not None for r in reloaders)

    def resident_engines(self) -> int:
        """Count of DISTINCT engine objects across tenants (dedupe: 32
        tenants on 4 rulesets report 4)."""
        with self._lock:
            reloaders = list(self._reloaders.values())
        return len({id(r.engine) for r in reloaders if r.engine is not None})

    @property
    def engine_dedup_hits(self) -> int:
        factory = self._engine_factory
        return factory.dedup_hits if isinstance(factory, SharedEngineFactory) else 0

    def force_rollback(self, key: str | None = None) -> dict | None:
        """Operator-forced rollback for one tenant (default tenant when
        ``key`` is None). Returns the swap summary or None when nothing
        to roll back to (unknown tenant / empty ring)."""
        key = (key or self.default_tenant or "").strip("/")
        with self._lock:
            reloader = self._reloaders.get(key)
        return reloader.force_rollback() if reloader is not None else None

    @property
    def total_rollbacks_forced(self) -> int:
        with self._lock:
            return sum(r.rollbacks_forced for r in self._reloaders.values())

    def stats(self) -> dict:
        with self._lock:
            reloaders = dict(self._reloaders)
        return {
            key: {
                "uuid": r.current_uuid,
                "reloads": r.reloads,
                "failed_reloads": r.failed_reloads,
                "poll_failures": r.poll_failures,
                "loaded": r.engine is not None,
                "analyze_rejected": r.analyze_rejected,
                "analysis": (
                    r.analysis.counts() if r.analysis is not None else None
                ),
                "rollbacks_forced": r.rollbacks_forced,
                "lkg_ring": r.ring.uuids(),
                "restored": r.restored,
            }
            for key, r in reloaders.items()
        }

    # -- durable serving state (docs/RECOVERY.md) ----------------------------

    def snapshot(self) -> dict:
        """Per-tenant serving-state snapshot for the state store. Tenants
        with nothing persistable (no engine / no ruleset text) are
        omitted — a restore simply cold-starts them."""
        with self._lock:
            reloaders = dict(self._reloaders)
        out: dict[str, dict] = {}
        for key, r in reloaders.items():
            snap = r.snapshot()
            if snap is not None:
                out[key] = snap
        return {"tenants": out}

    def restore(self, state: dict) -> int:
        """Restore every known tenant present in the snapshot; returns
        how many restored. Unknown tenant keys in the snapshot are
        ignored (the deployment's tenant list is config, not state)."""
        tenants = state.get("tenants")
        if not isinstance(tenants, dict):
            return 0
        restored = 0
        for key, snap in tenants.items():
            with self._lock:
                reloader = self._reloaders.get(str(key).strip("/"))
            if reloader is None or not isinstance(snap, dict):
                continue
            if reloader.engine is None and reloader.restore(snap):
                restored += 1
        return restored

    @property
    def total_restored(self) -> int:
        with self._lock:
            return sum(1 for r in self._reloaders.values() if r.restored)

    def analysis_counts(self) -> dict[str, int]:
        """Finding counts by severity summed across tenants' serving
        rulesets (the cko_analysis_findings_total metric)."""
        out = {"error": 0, "warn": 0, "info": 0}
        with self._lock:
            reloaders = list(self._reloaders.values())
        for r in reloaders:
            if r.analysis is not None:
                for sev, n in r.analysis.counts().items():
                    out[sev] = out.get(sev, 0) + n
        return out

    @property
    def total_analyze_rejected(self) -> int:
        with self._lock:
            return sum(r.analyze_rejected for r in self._reloaders.values())

    @property
    def total_reloads(self) -> int:
        with self._lock:
            return sum(r.reloads for r in self._reloaders.values())

    @property
    def total_failed_reloads(self) -> int:
        with self._lock:
            return sum(r.failed_reloads for r in self._reloaders.values())

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="tenant-reloader", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def poll_all_once(self) -> int:
        """Sweep every tenant once; returns the number of reloads."""
        with self._lock:
            reloaders = list(self._reloaders.values())
        return sum(1 for r in reloaders if r.poll_once())

    def _next_wait_s(self) -> float:
        """Shared-sweep analog of RuleReloader.next_wait_s: any tenant in
        failure backoff pulls the whole sweep forward (cheap — a sweep is
        one /latest probe per tenant)."""
        with self._lock:
            reloaders = list(self._reloaders.values())
        if not reloaders:
            return self.poll_interval_s
        return min(r.next_wait_s() for r in reloaders)

    def _run(self) -> None:
        self.poll_all_once()  # eager first load for every tenant
        while not self._stop.wait(self._next_wait_s()):
            self.poll_all_once()
