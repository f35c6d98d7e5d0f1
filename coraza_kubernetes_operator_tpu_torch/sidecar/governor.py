"""Ingress resource governance shared by both sidecar frontends.

The async frontend (``ingest.py``) and the legacy threaded frontend
(``server.py``) both consult one :class:`IngressGovernor` owned by the
sidecar.  It holds the global connection cap, the in-flight byte ledger
(parse buffers + request bodies awaiting a verdict), per-connection read
deadlines and the body-size ceiling, and every ``cko_ingress_*`` counter.

All methods are thread-safe: the async loop charges from the event-loop
thread while the threaded frontend charges from handler threads, and the
metrics registry reads counters from scrape threads.

Knob resolution order is ``SidecarConfig`` field (when not ``None``) →
environment variable → built-in default, so operators can tune a live
fleet with env alone.  Timeouts set to ``0`` are disabled; the connection
cap, body ceiling, and memory budget accept negative values to disable.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

DEFAULT_MAX_CONNECTIONS = 1024
DEFAULT_HEADER_TIMEOUT_S = 10.0
DEFAULT_IDLE_TIMEOUT_S = 75.0
DEFAULT_BODY_TIMEOUT_S = 30.0
DEFAULT_WRITE_TIMEOUT_S = 20.0
DEFAULT_MAX_BODY_BYTES = 10 * 1024 * 1024
DEFAULT_MEMORY_BUDGET_BYTES = 256 * 1024 * 1024
# Tenant-scoped shedding arms once the global ledger is this full: below
# it there is headroom for everyone and weighted fairness costs nothing;
# above it the noisiest tenant must 429 BEFORE the global budget trips
# and innocents feel it.
DEFAULT_TENANT_SHED_FRACTION = 0.5


class BodyTooLarge(Exception):
    """Request body exceeds the configured ceiling → 413."""


class BadContentLength(Exception):
    """Content-Length header is not a non-negative integer → 400."""


class MemoryShed(Exception):
    """Admitting this request would blow the in-flight byte budget → 429."""


class TenantShed(MemoryShed):
    """This tenant is over its weighted fair share while the ledger is
    under pressure → 429 for the noisy tenant only. Subclasses
    :class:`MemoryShed` so every existing 429 handler keeps the exact
    shed taxonomy."""

    def __init__(self, tenant: Optional[str], message: str) -> None:
        super().__init__(message)
        self.tenant = tenant


def parse_tenant_weights(raw: Optional[str]) -> Dict[str, float]:
    """Parse ``CKO_TENANT_WEIGHTS`` (``"tenantA=3,tenantB=1"``) into a
    weight table. Unknown/absent tenants weigh 1.0; malformed entries
    are dropped (a broken knob must never take the listener down)."""
    weights: Dict[str, float] = {}
    if not raw:
        return weights
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            w = float(val)
        except ValueError:
            continue
        if w > 0 and name.strip():
            weights[name.strip()] = w
    return weights


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _pick_f(cfg_value: Optional[float], env: str, default: float) -> float:
    if cfg_value is not None:
        return float(cfg_value)
    return _env_float(env, default)


def _pick_i(cfg_value: Optional[int], env: str, default: int) -> int:
    if cfg_value is not None:
        return int(cfg_value)
    return _env_int(env, default)


class IngressGovernor:
    """Global connection cap + in-flight byte ledger + read deadlines."""

    def __init__(
        self,
        *,
        max_connections: Optional[int] = None,
        header_timeout_s: Optional[float] = None,
        idle_timeout_s: Optional[float] = None,
        body_timeout_s: Optional[float] = None,
        write_timeout_s: Optional[float] = None,
        max_body_bytes: Optional[int] = None,
        memory_budget_bytes: Optional[int] = None,
        tenant_weights: Optional[str] = None,
    ) -> None:
        self.max_connections = _pick_i(
            max_connections, "CKO_INGRESS_MAX_CONNS", DEFAULT_MAX_CONNECTIONS
        )
        self.header_timeout_s = _pick_f(
            header_timeout_s, "CKO_INGRESS_HEADER_TIMEOUT_S", DEFAULT_HEADER_TIMEOUT_S
        )
        self.idle_timeout_s = _pick_f(
            idle_timeout_s, "CKO_INGRESS_IDLE_TIMEOUT_S", DEFAULT_IDLE_TIMEOUT_S
        )
        self.body_timeout_s = _pick_f(
            body_timeout_s, "CKO_INGRESS_BODY_TIMEOUT_S", DEFAULT_BODY_TIMEOUT_S
        )
        self.write_timeout_s = _pick_f(
            write_timeout_s, "CKO_INGRESS_WRITE_TIMEOUT_S", DEFAULT_WRITE_TIMEOUT_S
        )
        self.max_body_bytes = _pick_i(
            max_body_bytes, "CKO_INGRESS_MAX_BODY_BYTES", DEFAULT_MAX_BODY_BYTES
        )
        self.memory_budget_bytes = _pick_i(
            memory_budget_bytes,
            "CKO_INGRESS_MEMORY_BUDGET_BYTES",
            DEFAULT_MEMORY_BUDGET_BYTES,
        )

        # Per-tenant weighted-fair admission: configured
        # weights (default equal), the per-tenant slice of the in-flight
        # ledger, and tenant-scoped shed counters. config field →
        # CKO_TENANT_WEIGHTS → empty (every tenant weighs 1.0).
        if tenant_weights is None:
            tenant_weights = os.environ.get("CKO_TENANT_WEIGHTS", "")
        self.tenant_weights: Dict[str, float] = parse_tenant_weights(
            tenant_weights
        )
        self.tenant_shed_fraction = _env_float(
            "CKO_TENANT_SHED_FRACTION", DEFAULT_TENANT_SHED_FRACTION
        )

        self._lock = threading.Lock()
        self._conns = 0
        self._inflight_bytes = 0
        self._tenant_bytes: Dict[Optional[str], int] = {}
        self._tenant_reqs: Dict[Optional[str], int] = {}
        self.tenant_sheds: Dict[Optional[str], int] = {}

        # cko_ingress_* counters; read by the metrics registry + stats().
        self.conns_rejected_total = 0
        self.shed_total = 0
        self.deadline_closed_total = 0
        self.body_limit_total = 0
        self.slow_disconnects_total = 0
        self.conn_errors_total = 0
        self.aborted_total = 0

    # -- connection cap ---------------------------------------------------

    def try_admit_conn(self) -> bool:
        """Reserve a connection slot; False means over the cap (→ 503)."""
        with self._lock:
            if 0 <= self.max_connections <= self._conns:
                self.conns_rejected_total += 1
                return False
            self._conns += 1
            return True

    def release_conn(self) -> None:
        with self._lock:
            if self._conns > 0:
                self._conns -= 1

    # -- in-flight byte ledger --------------------------------------------

    def can_admit(self, nbytes: int) -> bool:
        """Probe the memory budget before reading a body off the wire."""
        if self.memory_budget_bytes < 0:
            return True
        with self._lock:
            return self._inflight_bytes + nbytes <= self.memory_budget_bytes

    def charge(self, nbytes: int, tenant: Optional[str] = None) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            self._inflight_bytes += nbytes
            if tenant is not None:
                self._tenant_bytes[tenant] = (
                    self._tenant_bytes.get(tenant, 0) + nbytes
                )
                self._tenant_reqs[tenant] = self._tenant_reqs.get(tenant, 0) + 1

    def discharge(self, nbytes: int, tenant: Optional[str] = None) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            self._inflight_bytes -= nbytes
            if self._inflight_bytes < 0:  # defensive: never go negative
                self._inflight_bytes = 0
            if tenant is not None:
                left = self._tenant_bytes.get(tenant, 0) - nbytes
                reqs = self._tenant_reqs.get(tenant, 0) - 1
                if left > 0:
                    self._tenant_bytes[tenant] = left
                else:
                    self._tenant_bytes.pop(tenant, None)
                if reqs > 0:
                    self._tenant_reqs[tenant] = reqs
                else:
                    self._tenant_reqs.pop(tenant, None)

    # -- per-tenant weighted fairness --------------------------

    def weight_for(self, tenant: Optional[str]) -> float:
        """Configured admission weight for one tenant (default 1.0; the
        default tenant may be keyed as ``default``)."""
        if tenant is None:
            return self.tenant_weights.get("default", 1.0)
        return self.tenant_weights.get(tenant, 1.0)

    def tenant_fair_share_bytes(self, tenant: Optional[str]) -> int:
        """This tenant's weighted slice of the memory budget, computed
        over the tenants CURRENTLY holding in-flight bytes (an idle
        fleet never dilutes the active ones)."""
        if self.memory_budget_bytes < 0:
            return -1
        with self._lock:
            active = set(self._tenant_bytes)
        active.add(tenant)
        total_w = sum(self.weight_for(t) for t in active)
        if total_w <= 0:
            return self.memory_budget_bytes
        return int(
            self.memory_budget_bytes * self.weight_for(tenant) / total_w
        )

    def tenant_over_share(self, tenant: Optional[str], nbytes: int) -> bool:
        """True when admitting ``nbytes`` for ``tenant`` should shed
        TENANT-scoped: the global ledger is under pressure (past
        ``tenant_shed_fraction`` of budget) AND this tenant would exceed
        its weighted fair share. Below the pressure line everyone rides
        the global budget alone — fairness only bites when scarcity is
        real, so a lone tenant can still use the whole budget."""
        if self.memory_budget_bytes < 0 or tenant is None:
            return False
        with self._lock:
            global_now = self._inflight_bytes
            tenant_now = self._tenant_bytes.get(tenant, 0)
        if global_now + nbytes <= (
            self.memory_budget_bytes * self.tenant_shed_fraction
        ):
            return False
        return tenant_now + nbytes > self.tenant_fair_share_bytes(tenant)

    def count_tenant_shed(self, tenant: Optional[str]) -> None:
        with self._lock:
            self.tenant_sheds[tenant] = self.tenant_sheds.get(tenant, 0) + 1

    def tenant_ledger(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant snapshot for stats()/metrics (None keyed as
        ``default``)."""
        with self._lock:
            tenants = (
                set(self._tenant_bytes)
                | set(self._tenant_reqs)
                | set(self.tenant_sheds)
            )
            return {
                (t if t is not None else "default"): {
                    "inflight_bytes": self._tenant_bytes.get(t, 0),
                    "inflight_requests": self._tenant_reqs.get(t, 0),
                    "shed_total": self.tenant_sheds.get(t, 0),
                    "weight": self.weight_for(t),
                }
                for t in tenants
            }

    # -- counters ---------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    @property
    def connections(self) -> int:
        with self._lock:
            return self._conns

    @property
    def inflight_bytes(self) -> int:
        with self._lock:
            return self._inflight_bytes

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "connections": self._conns,
                "max_connections": self.max_connections,
                "inflight_bytes": self._inflight_bytes,
                "memory_budget_bytes": self.memory_budget_bytes,
                "max_body_bytes": self.max_body_bytes,
                "header_timeout_s": self.header_timeout_s,
                "idle_timeout_s": self.idle_timeout_s,
                "body_timeout_s": self.body_timeout_s,
                "write_timeout_s": self.write_timeout_s,
                "conns_rejected_total": self.conns_rejected_total,
                "shed_total": self.shed_total,
                "deadline_closed_total": self.deadline_closed_total,
                "body_limit_total": self.body_limit_total,
                "slow_disconnects_total": self.slow_disconnects_total,
                "conn_errors_total": self.conn_errors_total,
                "aborted_total": self.aborted_total,
                "tenant_shed_fraction": self.tenant_shed_fraction,
                "tenant_weights": dict(self.tenant_weights),
            }
