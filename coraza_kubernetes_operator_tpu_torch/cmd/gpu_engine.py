"""``gpu-engine`` sidecar entrypoint: the port of ``cmd/tpu_engine.py``,
serving on the card (``python -m
coraza_kubernetes_operator_tpu_torch.cmd.gpu_engine``).

Flags are the reference's and mirror the args the Engine controller renders into the sidecar
Deployment (``controlplane/engine_controller.py:build_gpu_engine_deployment``):
cache instance/cluster/port, reload interval, failure policy, batching knobs.
``--cache-server-cluster`` accepts a host or host:port — in-mesh this is the
Envoy cluster name (reference ``--envoy-cluster-name``), standalone it is
the cache server address.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from ..sidecar.batcher import DEFAULT_MAX_BATCH_DELAY_MS, DEFAULT_MAX_BATCH_SIZE
from ..sidecar.reloader import DEFAULT_POLL_INTERVAL_S
from ..sidecar.server import (
    FAILURE_POLICY_ALLOW,
    FAILURE_POLICY_FAIL,
    SidecarConfig,
    TpuEngineSidecar,
)
from ..utils import get_logger

log = get_logger("cmd.gpu-engine")


def build_config(argv: list[str] | None = None) -> SidecarConfig:
    p = argparse.ArgumentParser(prog="gpu-engine", description=__doc__)
    p.add_argument(
        "--cache-server-instance",
        required=True,
        help="RuleSet cache key 'namespace/name' to poll; a comma-separated"
        " list serves multiple tenants (first is the default, others are"
        " selected per request via X-Waf-Tenant)",
    )
    p.add_argument(
        "--cache-server-cluster",
        default="127.0.0.1",
        help="Cache server host (or host:port); in-mesh, the Envoy cluster name",
    )
    p.add_argument("--cache-server-port", type=int, default=18080)
    p.add_argument(
        "--rule-reload-interval-seconds",
        type=float,
        default=DEFAULT_POLL_INTERVAL_S,
    )
    p.add_argument(
        "--failure-policy",
        choices=[FAILURE_POLICY_FAIL, FAILURE_POLICY_ALLOW],
        default=FAILURE_POLICY_FAIL,
    )
    p.add_argument("--max-batch-size", type=int, default=DEFAULT_MAX_BATCH_SIZE)
    p.add_argument(
        "--max-batch-delay-ms", type=float, default=DEFAULT_MAX_BATCH_DELAY_MS
    )
    p.add_argument(
        "--pipeline-depth",
        type=int,
        default=None,
        help="max batch windows in flight on device while the next one"
        " assembles (double-buffered dispatch, docs/PIPELINE.md); default"
        " $CKO_PIPELINE_DEPTH or 2, 1 reverts to synchronous dispatch",
    )
    p.add_argument(
        "--request-timeout-seconds",
        type=float,
        default=None,
        help="per-request verdict wait budget; default $CKO_REQUEST_TIMEOUT_S"
        " or 30",
    )
    p.add_argument(
        "--window-deadline-seconds",
        type=float,
        default=None,
        help="dispatch-watchdog per-window device deadline"
        " (docs/DEGRADED_MODE.md); default $CKO_WINDOW_DEADLINE_S or auto"
        " (~10x warm p99 once warmed); <= 0 disables",
    )
    p.add_argument(
        "--compile-timeout-seconds",
        type=float,
        default=600.0,
        help="first-evaluation budget while a freshly loaded ruleset's stages"
        " warm; the strict request timeout applies afterwards",
    )
    p.add_argument("--bind-address", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9090)
    p.add_argument(
        "--frontend",
        choices=["async", "threaded"],
        default="async",
        help="ingest frontend (docs/SERVING.md): 'async' is the"
        " asyncio-native single-acceptor loop with keep-alive,"
        " pipelining, and zero-copy window assembly; 'threaded' is the"
        " legacy ThreadingHTTPServer escape hatch",
    )
    p.add_argument(
        "--extproc-port",
        type=int,
        default=None,
        help="Envoy ext_proc gRPC listener port (docs/EXTPROC.md);"
        " unset reads $CKO_EXTPROC_PORT, default off. The frontend is not"
        " ported yet: setting it refuses to start",
    )
    p.add_argument(
        "--extproc-impl",
        choices=["auto", "native", "grpcio"],
        default="auto",
        help="ext_proc transport: 'auto' serves via grpcio when"
        " importable and falls back to the dependency-free HTTP/2"
        " subset; pin with 'native'/'grpcio' (or $CKO_EXTPROC_IMPL)",
    )
    p.add_argument(
        "--audit-log",
        default="",
        help="audit log destination: '-' for stdout (SecAuditLog /dev/stdout"
        " parity), a file path, or empty to disable",
    )
    p.add_argument(
        "--audit-all",
        action="store_true",
        help="log every transaction, not just matches (SecAuditEngine On"
        " instead of RelevantOnly)",
    )
    p.add_argument(
        "--disable-host-fallback",
        action="store_true",
        help="disable degraded-mode serving from the host fallback"
        " evaluator (reverts to waiting out stage warms; the"
        " failurePolicy alone covers device faults)",
    )
    p.add_argument(
        "--queue-budget",
        type=int,
        default=4096,
        help="batcher backlog above which device-path requests are shed"
        " with 429 + Retry-After (negative disables shedding)",
    )
    p.add_argument(
        "--breaker-threshold",
        type=int,
        default=3,
        help="consecutive device failures before the circuit breaker opens"
        " and serving demotes to the host fallback",
    )
    p.add_argument(
        "--breaker-cooldown-seconds",
        type=float,
        default=30.0,
        help="cooldown before a half-open device re-probe",
    )
    p.add_argument(
        "--drain-timeout-seconds",
        type=float,
        default=2.0,
        help="shutdown drain budget: seconds to wait for in-flight ingest"
        " windows before force-closing connections (counted in"
        " cko_ingest_aborted_total)",
    )
    p.add_argument(
        "--state-dir",
        default=None,
        help="durable serving-state directory (default $CKO_STATE_DIR;"
        " empty disables): the serving ruleset, last-known-good ring, and"
        " rollout latches persist here on every promote/swap/rollback,"
        " and a restart restores them before the first cache poll"
        " (docs/RECOVERY.md)",
    )
    p.add_argument(
        "--drain-budget-seconds",
        type=float,
        default=None,
        help="graceful-termination budget (default $CKO_DRAIN_BUDGET_S or"
        " 10): SIGTERM flips readyz to 503 immediately, then in-flight"
        " and queued windows drain to real verdicts within this budget"
        " before the process exits",
    )
    p.add_argument(
        "--max-connections",
        type=int,
        default=None,
        help="global concurrent-connection cap, 503 past it (default"
        " $CKO_INGRESS_MAX_CONNS or 1024; negative disables)",
    )
    p.add_argument(
        "--header-timeout-seconds",
        type=float,
        default=None,
        help="total deadline from first head byte to complete request head,"
        " 408 past it — slowloris defense (default"
        " $CKO_INGRESS_HEADER_TIMEOUT_S or 10; 0 disables)",
    )
    p.add_argument(
        "--idle-timeout-seconds",
        type=float,
        default=None,
        help="keep-alive idle timeout before a quiet connection closes"
        " (default $CKO_INGRESS_IDLE_TIMEOUT_S or 75; 0 disables)",
    )
    p.add_argument(
        "--body-timeout-seconds",
        type=float,
        default=None,
        help="total deadline for reading a request body, 408 past it"
        " (default $CKO_INGRESS_BODY_TIMEOUT_S or 30; 0 disables)",
    )
    p.add_argument(
        "--max-body-bytes",
        type=int,
        default=None,
        help="request-body ceiling, 413 during the read — never buffered"
        " (default $CKO_INGRESS_MAX_BODY_BYTES or 10485760; negative"
        " disables)",
    )
    p.add_argument(
        "--ingress-memory-budget-bytes",
        type=int,
        default=None,
        help="global in-flight request-byte budget; new work sheds 429"
        " past it while control endpoints stay live (default"
        " $CKO_INGRESS_MEMORY_BUDGET_BYTES or 268435456; negative"
        " disables)",
    )
    p.add_argument(
        "--compile-cache-dir",
        default=None,
        help="persistent build directory (default $CKO_COMPILE_CACHE_DIR):"
        " the nvcc kernel libraries and the native host runtime are built"
        " there once, and cold sidecar starts find them built; '0'"
        " disables",
    )
    p.add_argument(
        "--disable-rollout",
        action="store_true",
        help="revert hot reloads to the legacy compile-gate-swap path"
        " instead of the staged rollout pipeline (docs/ROLLOUT.md:"
        " budgeted background compile, shadow verification, rollback)",
    )
    p.add_argument(
        "--compile-budget-seconds",
        type=float,
        default=None,
        help="wall budget for a rollout candidate's compile + prewarm"
        " (default $CKO_COMPILE_BUDGET_S or 600); a blown budget records"
        " a failed rollout and leaves serving untouched",
    )
    p.add_argument(
        "--shadow-promote-windows",
        type=int,
        default=None,
        help="shadow-verified windows required to promote a candidate"
        " (default $CKO_SHADOW_PROMOTE_WINDOWS or 3; 0 swaps directly)",
    )
    p.add_argument(
        "--shadow-sample-rate",
        type=float,
        default=None,
        help="fraction of live windows mirrored through a staged"
        " candidate (default $CKO_SHADOW_SAMPLE_RATE or 1.0)",
    )
    p.add_argument(
        "--trace-sample-rate",
        type=float,
        default=None,
        help="flight-recorder sampling (docs/OBSERVABILITY.md): fraction"
        " of requests without a traceparent header that are traced"
        " end-to-end; requests carrying the header are always recorded"
        " when > 0 (default $CKO_TRACE_SAMPLE_RATE or 0 = off)",
    )
    p.add_argument(
        "--trace-ring",
        type=int,
        default=None,
        help="max completed traces retained for GET /waf/v1/trace"
        " (default $CKO_TRACE_RING or 512)",
    )
    p.add_argument(
        "--audit-max-bytes",
        type=int,
        default=None,
        help="audit-log size cap: keep-1 rotation to <path>.1 once the"
        " live file would exceed this many bytes (default"
        " $CKO_AUDIT_MAX_BYTES or 0 = unbounded; file-backed logs only)",
    )
    p.add_argument(
        "--slo-p99-ms",
        type=float,
        default=None,
        help="p99 step-latency target the adaptive scheduler steers"
        " toward (docs/SERVING.md; default $CKO_SLO_P99_MS or 50)",
    )
    p.add_argument(
        "--tenant-weights",
        default=None,
        help="comma-separated tenant=weight pairs for weighted-fair"
        " admission, e.g. 'gold=3,free=1'; 'default' sets the weight"
        " for unlisted tenants (default $CKO_TENANT_WEIGHTS or all 1)",
    )
    p.add_argument(
        "--lane-delay-ms",
        type=float,
        default=None,
        help="base micro-batch window for the interactive (headers-only)"
        " lane in milliseconds; the bulk lane keeps --max-batch-delay-ms"
        " (default $CKO_LANE_DELAY_MS or the bulk delay)",
    )
    p.add_argument(
        "--disable-adaptive",
        action="store_true",
        help="kill switch for the trace-driven adaptive scheduler: lane"
        " delays, pipeline depth and queue budgets stay at their static"
        " configured values",
    )
    args = p.parse_args(argv)

    # Wire the persistent build directory BEFORE any engine builds: a
    # restart of this sidecar (or any sibling pointed at the same dir)
    # loads the kernel libraries built before instead of rebuilding them.
    from ..engine.compile_cache import configure_persistent_cache

    configure_persistent_cache(args.compile_cache_dir)

    cluster = args.cache_server_cluster
    if ":" in cluster:
        base_url = f"http://{cluster}"
    else:
        base_url = f"http://{cluster}:{args.cache_server_port}"
    return SidecarConfig(
        cache_base_url=base_url,
        instance_key=args.cache_server_instance,
        poll_interval_s=args.rule_reload_interval_seconds,
        failure_policy=args.failure_policy,
        max_batch_size=args.max_batch_size,
        max_batch_delay_ms=args.max_batch_delay_ms,
        pipeline_depth=args.pipeline_depth,
        host=args.bind_address,
        port=args.port,
        frontend=args.frontend,
        extproc_port=args.extproc_port,
        extproc_impl=args.extproc_impl,
        request_timeout_s=args.request_timeout_seconds,
        window_deadline_s=args.window_deadline_seconds,
        compile_timeout_s=args.compile_timeout_seconds,
        audit_log=args.audit_log or None,
        audit_relevant_only=not args.audit_all,
        fallback_enabled=not args.disable_host_fallback,
        queue_budget=args.queue_budget,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_seconds,
        rollout_enabled=not args.disable_rollout,
        compile_budget_s=args.compile_budget_seconds,
        shadow_promote_windows=args.shadow_promote_windows,
        shadow_sample_rate=args.shadow_sample_rate,
        drain_timeout_s=args.drain_timeout_seconds,
        state_dir=args.state_dir,
        drain_budget_s=args.drain_budget_seconds,
        max_connections=args.max_connections,
        header_timeout_s=args.header_timeout_seconds,
        idle_timeout_s=args.idle_timeout_seconds,
        body_timeout_s=args.body_timeout_seconds,
        max_body_bytes=args.max_body_bytes,
        ingress_memory_budget_bytes=args.ingress_memory_budget_bytes,
        trace_sample_rate=args.trace_sample_rate,
        trace_ring=args.trace_ring,
        audit_max_bytes=args.audit_max_bytes,
        slo_p99_ms=args.slo_p99_ms,
        tenant_weights=args.tenant_weights,
        lane_delay_ms=args.lane_delay_ms,
        adaptive_enabled=not args.disable_adaptive,
    )


def main(argv: list[str] | None = None) -> int:
    config = build_config(argv)
    sidecar = TpuEngineSidecar(config)
    stop = threading.Event()

    def on_signal(_signum, _frame):
        # Graceful termination (docs/RECOVERY.md): readyz flips to 503
        # immediately — Kubernetes stops routing while the preStop sleep
        # and endpoint propagation run — then the main thread drains and
        # persists state via sidecar.stop().
        sidecar.begin_drain()
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    sidecar.start()
    log.info("serving", port=sidecar.port)
    stop.wait()
    sidecar.stop()
    # The drain is complete and the state snapshot is on disk. Exit
    # decisively: letting the interpreter unwind races the CUDA runtime's
    # static destructors against daemon threads still holding the
    # context, which can abort a process whose drain was perfectly clean.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
