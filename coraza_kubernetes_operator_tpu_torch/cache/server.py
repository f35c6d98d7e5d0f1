"""HTTP cache server: the rule-distribution endpoint data planes poll.

Protocol parity with reference ``internal/rulesets/cache/server.go``:

- ``GET /rules/{ns/name}``        → full latest entry ``{uuid, timestamp, rules}``
- ``GET /rules/{ns/name}/latest`` → ``{uuid, timestamp}``
- missing key → 404 "RuleSet not found"; empty key → 400; non-GET → 405.

Hardening mirrors the reference: 64KB max header size, 5s header read
timeout, graceful 10s shutdown drain, and a background GC loop pruning by
age then size, logging CRITICAL when the latest entry alone exceeds the cap
(``server.go:228-256``). Runs on every replica (no leader election), since
serving cached rules is read-only.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..observability import MetricsRegistry
from ..utils import get_logger
from .cache import RuleSetCache, format_timestamp

log = get_logger("cache.server")

DEFAULT_CACHE_SERVER_PORT = 18080

CACHE_GC_INTERVAL = timedelta(minutes=5)
CACHE_MAX_AGE = timedelta(hours=24)
CACHE_MAX_SIZE = 100 * 1024 * 1024  # 100MB
MAX_HEADER_SIZE = 64 * 1024
READ_HEADER_TIMEOUT_S = 5.0
GRACEFUL_SHUTDOWN_TIMEOUT_S = 10.0


@dataclass
class GarbageCollectionConfig:
    gc_interval: timedelta = CACHE_GC_INTERVAL
    max_age: timedelta = CACHE_MAX_AGE
    max_size: int = CACHE_MAX_SIZE


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "cko-tpu-cache"
    # Reference hardening: cap header bytes, bound header read time.
    max_headers = 200

    def setup(self) -> None:
        super().setup()
        self.connection.settimeout(READ_HEADER_TIMEOUT_S)

    @property
    def cache(self) -> RuleSetCache:
        return self.server.cache  # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args) -> None:
        log.debug("http " + fmt % args)

    def _reply(self, status: int, payload: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _error(self, status: int, message: str) -> None:
        self._reply(status, (message + "\n").encode(), "text/plain; charset=utf-8")

    def do_GET(self) -> None:  # noqa: N802
        if len(self.requestline) > MAX_HEADER_SIZE:
            self._error(431, "Request header too large")
            return
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            metrics: MetricsRegistry = self.server.metrics  # type: ignore[attr-defined]
            self._reply(
                200,
                metrics.render().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
            return
        if not path.startswith("/rules/"):
            self._error(404, "Not found")
            return
        key = path[len("/rules/") :]
        if not key:
            self._error(400, "RuleSet key required")
            return
        self.server.m_requests.inc(  # type: ignore[attr-defined]
            endpoint="latest" if key.endswith("/latest") else "rules"
        )
        if key.endswith("/latest"):
            self._handle_latest(key[: -len("/latest")])
        else:
            self._handle_get_rules(key)

    def do_POST(self) -> None:  # noqa: N802
        self._error(405, "Method not allowed")

    do_PUT = do_DELETE = do_PATCH = do_POST  # noqa: N815

    def _handle_latest(self, key: str) -> None:
        entry = self.cache.get(key)
        if entry is None:
            self._error(404, "RuleSet not found")
            return
        payload = json.dumps(
            {"uuid": entry.uuid, "timestamp": format_timestamp(entry.timestamp)}
        ).encode()
        self._reply(200, payload, "application/json")

    def _handle_get_rules(self, key: str) -> None:
        entry = self.cache.get(key)
        if entry is None:
            self._error(404, "RuleSet not found")
            return
        log.info(
            "Serving rules from cache",
            cacheKey=key,
            uuid=entry.uuid,
            availableKeys=self.cache.list_keys(),
            cacheSizeBytes=self.cache.total_size(),
        )
        self._reply(200, json.dumps(entry.to_json()).encode(), "application/json")


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class RuleSetCacheServer:
    """Manager runnable: serves the cache and garbage-collects it."""

    def __init__(
        self,
        cache: RuleSetCache,
        host: str = "0.0.0.0",
        port: int = DEFAULT_CACHE_SERVER_PORT,
        gc: GarbageCollectionConfig | None = None,
    ):
        self.cache = cache
        self.gc = gc or GarbageCollectionConfig()
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "ruleset_cache_requests_total", "Cache endpoint hits", ("endpoint",)
        )
        self._m_pruned = self.metrics.counter(
            "ruleset_cache_pruned_total", "GC-pruned entries", ("reason",)
        )
        self.metrics.gauge(
            "ruleset_cache_bytes", "Total cached rule bytes"
        ).set_function(cache.total_size)
        self.metrics.gauge(
            "ruleset_cache_keys", "Distinct cached ruleset keys"
        ).set_function(lambda: float(len(cache.list_keys())))
        self._httpd = _Server((host, port), _Handler)
        self._httpd.cache = cache  # type: ignore[attr-defined]
        self._httpd.metrics = self.metrics  # type: ignore[attr-defined]
        self._httpd.m_requests = self._m_requests  # type: ignore[attr-defined]
        self._serve_thread: threading.Thread | None = None
        self._gc_stop = threading.Event()
        self._gc_thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def needs_leader_election(self) -> bool:
        """Serving cached rules is read-only — run on every replica
        (reference ``server.go:135-137``)."""
        return False

    def start(self) -> None:
        log.info("Starting ruleset cache server", addr=f":{self.port}")
        self._gc_thread = threading.Thread(target=self._run_gc, daemon=True)
        self._gc_thread.start()
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._serve_thread.start()

    def stop(self) -> None:
        log.info("Shutting down ruleset cache server")
        self._gc_stop.set()
        self._httpd.shutdown()
        if self._serve_thread:
            self._serve_thread.join(timeout=GRACEFUL_SHUTDOWN_TIMEOUT_S)
        self._httpd.server_close()
        log.info("Cache server shutdown complete")

    def _run_gc(self) -> None:
        interval = self.gc.gc_interval.total_seconds()
        while not self._gc_stop.wait(interval):
            pruned_by_age = self.cache.prune(self.gc.max_age)
            if pruned_by_age:
                self._m_pruned.inc(pruned_by_age, reason="age")
                log.info(
                    "Pruned stale cache entries by age",
                    count=pruned_by_age,
                    maxAge=str(self.gc.max_age),
                )
            current = self.cache.total_size()
            if current > self.gc.max_size:
                pruned_by_size = self.cache.prune_by_size(self.gc.max_size)
                if pruned_by_size:
                    self._m_pruned.inc(pruned_by_size, reason="size")
                    log.info(
                        "Pruned cache entries by size",
                        count=pruned_by_size,
                        maxSize=self.gc.max_size,
                        currentSize=self.cache.total_size(),
                    )
                final = self.cache.total_size()
                if final > self.gc.max_size:
                    log.error(
                        "CRITICAL: Cache size exceeds maximum even after pruning"
                        " - latest entry is too large",
                        currentSize=final,
                        maxSize=self.gc.max_size,
                        overage=final - self.gc.max_size,
                    )
