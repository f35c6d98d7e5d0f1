"""Controller manager: watches → workqueue → reconcile workers.

The controller-runtime analog (reference ``internal/controller/manager.go``
+ ``cmd/main.go`` wiring): registers both reconcilers, wires watches
(RuleSet spec changes, ConfigMap→RuleSet mapping, Engine spec changes,
owned WasmPlugin/Deployment changes → owner Engine), and runs a
deduplicating delay-queue with per-item exponential failure backoff
1s→60s (reference ``ruleset_controller.go:73-78``).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field

from ..cache import RuleSetCache
from ..utils import get_logger
from .engine_controller import EngineReconciler
from .events import EventRecorder
from .ruleset_controller import (
    ReconcileError,
    RuleSetReconciler,
    find_rulesets_for_configmap,
)
from .store import ObjectStore

log = get_logger("controller.manager")

BASE_BACKOFF_S = 1.0
MAX_BACKOFF_S = 60.0
DEFAULT_CACHE_SERVER_PORT = 18080


@dataclass(order=True)
class _QueueItem:
    ready_at: float
    seq: int
    key: tuple = field(compare=False)  # (controller, namespace, name)


class WorkQueue:
    """Deduplicating delay queue with per-key exponential failure backoff."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._heap: list[_QueueItem] = []
        self._pending: set[tuple] = set()
        self._failures: dict[tuple, int] = {}
        self._seq = itertools.count()
        self._shutdown = False

    def add(self, key: tuple, delay_s: float = 0.0) -> None:
        with self._cond:
            if key in self._pending or self._shutdown:
                return
            self._pending.add(key)
            heapq.heappush(
                self._heap, _QueueItem(time.monotonic() + delay_s, next(self._seq), key)
            )
            self._cond.notify()

    def add_rate_limited(self, key: tuple) -> None:
        """Requeue after exponential per-key backoff (1s → 60s)."""
        with self._cond:
            count = self._failures.get(key, 0) + 1
            self._failures[key] = count
        delay = min(BASE_BACKOFF_S * (2 ** (count - 1)), MAX_BACKOFF_S)
        self.add(key, delay)

    def forget(self, key: tuple) -> None:
        with self._cond:
            self._failures.pop(key, None)

    def get(self, timeout: float | None = None) -> tuple | None:
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._cond:
            while True:
                if self._shutdown:
                    return None
                now = time.monotonic()
                if self._heap and self._heap[0].ready_at <= now:
                    item = heapq.heappop(self._heap)
                    self._pending.discard(item.key)
                    return item.key
                wait = None
                if self._heap:
                    wait = self._heap[0].ready_at - now
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    wait = min(wait, remaining) if wait is not None else remaining
                self._cond.wait(timeout=wait)

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._heap)


class ControllerManager:
    """Wires store watches to reconcilers via the workqueue; runs workers."""

    def __init__(
        self,
        store: ObjectStore,
        cache: RuleSetCache,
        recorder: EventRecorder | None = None,
        cache_server_cluster: str = "",
        cache_server_port: int = DEFAULT_CACHE_SERVER_PORT,
        workers: int = 1,
    ):
        if not cache_server_cluster:
            # Parity with the required --envoy-cluster-name flag
            # (cmd/main.go:112-115): refuse to run unconfigured.
            raise ValueError("cache_server_cluster is required")
        self.store = store
        self.cache = cache
        self.recorder = recorder or EventRecorder()
        self.ruleset_reconciler = RuleSetReconciler(store, cache, self.recorder)
        self.engine_reconciler = EngineReconciler(
            store, self.recorder, cache_server_cluster, cache_server_port
        )
        self.queue = WorkQueue()
        self._threads: list[threading.Thread] = []
        self._n_workers = workers
        self._setup_watches()

    # -- watch topology ------------------------------------------------------

    def _setup_watches(self) -> None:
        def on_ruleset(_event: str, obj) -> None:
            self.queue.add(("RuleSet", obj.metadata.namespace, obj.metadata.name))

        def on_configmap(_event: str, cm) -> None:
            for ns, name in find_rulesets_for_configmap(self.store, cm):
                self.queue.add(("RuleSet", ns, name))

        def on_engine(_event: str, obj) -> None:
            self.queue.add(("Engine", obj.metadata.namespace, obj.metadata.name))

        def on_owned(_event: str, obj) -> None:
            for ref in obj.metadata.owner_references:
                if ref.get("kind") == "Engine":
                    self.queue.add(
                        ("Engine", obj.metadata.namespace, ref.get("name", ""))
                    )

        self.store.watch("RuleSet", on_ruleset)
        self.store.watch("ConfigMap", on_configmap)
        self.store.watch("Engine", on_engine)
        self.store.watch("WasmPlugin", on_owned)
        self.store.watch("Deployment", on_owned)

    # -- run loop ------------------------------------------------------------

    def start(self) -> None:
        for i in range(self._n_workers):
            t = threading.Thread(target=self._worker, name=f"reconcile-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        log.info("controller manager started", workers=self._n_workers)

    def stop(self) -> None:
        self.queue.shutdown()
        for t in self._threads:
            t.join(timeout=5)

    def _worker(self) -> None:
        while True:
            key = self.queue.get()
            if key is None:
                return
            self._process(key)

    def _process(self, key: tuple) -> None:
        controller, namespace, name = key
        reconciler = (
            self.ruleset_reconciler if controller == "RuleSet" else self.engine_reconciler
        )
        try:
            result = reconciler.reconcile(namespace, name)
        except ReconcileError as err:
            log.info("reconcile error, backing off", key=key, error=str(err))
            self.queue.add_rate_limited(key)
            return
        except Exception as err:  # unexpected — still back off, don't die
            log.error("reconcile panic, backing off", err, key=key)
            self.queue.add_rate_limited(key)
            return
        if result.requeue:
            self.queue.add_rate_limited(key)
        else:
            self.queue.forget(key)

    # -- test helper ---------------------------------------------------------

    def drain(self, timeout_s: float = 10.0, settle_s: float = 0.05) -> None:
        """Process queued work synchronously until idle (test helper — the
        reference envtest tier invokes Reconcile directly instead)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            key = self.queue.get(timeout=settle_s)
            if key is None:
                return  # nothing ready (backoff-delayed items may remain)
            self._process(key)
