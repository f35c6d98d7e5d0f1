"""Engine reconciler: attach a data plane for an Engine resource.

Parity with reference ``internal/controller/engine_controller.go`` +
``engine_controller_driver_istio.go``: driver dispatch, Istio/WASM
provisioning builds a WasmPlugin named ``coraza-engine-<engine>`` whose
pluginConfig carries ``cache_server_instance`` ("ns/rulesetName"),
``cache_server_cluster`` (the operator flag) and
``rule_reload_interval_seconds``; owner reference enables GC; server-side
apply; Ready/Degraded conditions + events. Invalid driver shapes emit
Warning/InvalidConfiguration + Degraded (``engine_controller.go:144-157``).

New beyond the reference: the ``gpu`` driver provisions the gpu-engine
sidecar Deployment (``spec.driver.gpu``, one NVIDIA card per pod), wired to the
same cache poll contract — including the Engine's ``failurePolicy``, which
the reference stores but never forwards (SURVEY §5 failure detection note);
the sidecar actually enforces fail-closed/fail-open.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import get_logger
from .api_types import DEFAULT_POLL_SECONDS, Engine, ObjectMeta
from .conditions import set_status_degraded, set_status_progressing, set_status_ready
from .events import EventRecorder
from .ruleset_controller import ReconcileResult
from .store import ObjectStore

log = get_logger("controller.engine")

WASM_PLUGIN_NAME_PREFIX = "coraza-engine-"
GPU_ENGINE_NAME_PREFIX = "coraza-gpu-engine-"
# Graceful-termination sizing (docs/RECOVERY.md): SIGTERM flips readyz to
# 503 immediately; the preStop sleep covers endpoint-removal propagation
# (new traffic stops arriving BEFORE the process starts draining), the
# drain budget bounds in-flight/queued window evaluation, and the pod
# grace period must cover both plus state-persist margin — otherwise the
# kubelet's SIGKILL lands mid-drain and verdicts are lost.
GPU_ENGINE_PRESTOP_SLEEP_SECONDS = 5
GPU_ENGINE_DRAIN_BUDGET_SECONDS = 10
GPU_ENGINE_TERMINATION_GRACE_SECONDS = 30


@dataclass
class Unstructured:
    """Dynamic object (WasmPlugin / Deployment manifests) stored alongside
    typed resources — the unstructured.Unstructured analog."""

    kind: str
    api_version: str
    metadata: ObjectMeta
    spec: dict = field(default_factory=dict)


class EngineReconciler:
    kind = "Engine"

    def __init__(
        self,
        store: ObjectStore,
        recorder: EventRecorder,
        cache_server_cluster: str,
        cache_server_port: int = 18080,
    ):
        self.store = store
        self.recorder = recorder
        # The Envoy cluster name through which the mesh reaches the cache
        # server (reference --envoy-cluster-name, cmd/main.go:101,112-115).
        self.cache_server_cluster = cache_server_cluster
        self.cache_server_port = cache_server_port

    def reconcile(self, namespace: str, name: str) -> ReconcileResult:
        engine: Engine | None = self.store.try_get("Engine", namespace, name)
        if engine is None or engine.metadata.deleted:
            return ReconcileResult()

        generation = engine.metadata.generation
        set_status_progressing(
            engine.status.conditions, generation, "Reconciling", "Provisioning engine"
        )
        self.store.update_status(engine)

        driver = engine.spec.driver
        if driver.istio is not None and driver.istio.wasm is not None:
            return self._provision_istio_wasm(engine)
        if driver.gpu is not None:
            return self._provision_gpu(engine)
        return self._invalid_configuration(
            engine, "no supported driver configuration found"
        )

    # -- istio/wasm driver (reference parity) --------------------------------

    def _provision_istio_wasm(self, engine: Engine) -> ReconcileResult:
        plugin = self.build_wasm_plugin(engine)
        try:
            self.store.apply(plugin)
        except Exception as err:  # provisioning failure path
            msg = f"Failed to apply WasmPlugin: {err}"
            self.recorder.event(engine, "Warning", "ProvisioningFailed", msg)
            set_status_degraded(
                engine.status.conditions,
                engine.metadata.generation,
                "ProvisioningFailed",
                msg,
            )
            self.store.update_status(engine)
            raise

        msg = f"WasmPlugin {plugin.metadata.name} created"
        self.recorder.event(engine, "Normal", "WasmPluginCreated", msg)
        set_status_ready(
            engine.status.conditions, engine.metadata.generation, "WasmPluginCreated", msg
        )
        self.store.update_status(engine)
        return ReconcileResult()

    def build_wasm_plugin(self, engine: Engine) -> Unstructured:
        wasm = engine.spec.driver.istio.wasm
        ruleset_key = f"{engine.metadata.namespace}/{engine.spec.rule_set.name}"
        plugin_config: dict = {
            "cache_server_instance": ruleset_key,
            "cache_server_cluster": self.cache_server_cluster,
        }
        if wasm.rule_set_cache_server is not None:
            plugin_config["rule_reload_interval_seconds"] = (
                wasm.rule_set_cache_server.poll_interval_seconds
            )
        return Unstructured(
            kind="WasmPlugin",
            api_version="extensions.istio.io/v1alpha1",
            metadata=ObjectMeta(
                name=f"{WASM_PLUGIN_NAME_PREFIX}{engine.metadata.name}",
                namespace=engine.metadata.namespace,
                owner_references=self._owner_refs(engine),
            ),
            spec={
                "url": wasm.image,
                "pluginConfig": plugin_config,
                "selector": {
                    "matchLabels": (wasm.workload_selector or {}).get("matchLabels", {})
                },
            },
        )

    # -- gpu driver --------------------------------------------------------

    def _provision_gpu(self, engine: Engine) -> ReconcileResult:
        deployment = self.build_gpu_engine_deployment(engine)
        service = self.build_gpu_engine_service(engine)
        objects: list[tuple[str, Unstructured]] = [
            ("Deployment", deployment),
            ("Service", service),
        ]
        if engine.spec.driver.gpu.gateway_attachment is not None:
            objects.append(("EnvoyFilter", self.build_envoy_filter(engine)))
        for what, obj in objects:
            try:
                self.store.apply(obj)
            except Exception as err:
                msg = f"Failed to apply gpu-engine {what}: {err}"
                self.recorder.event(engine, "Warning", "ProvisioningFailed", msg)
                set_status_degraded(
                    engine.status.conditions,
                    engine.metadata.generation,
                    "ProvisioningFailed",
                    msg,
                )
                self.store.update_status(engine)
                raise

        if engine.spec.driver.gpu.gateway_attachment is not None:
            self.recorder.event(
                engine,
                "Normal",
                "GatewayAttached",
                f"EnvoyFilter {GPU_ENGINE_NAME_PREFIX}{engine.metadata.name} "
                "routes gateway traffic through ext_proc",
            )
        msg = f"GPU engine {deployment.metadata.name} provisioned"
        self.recorder.event(engine, "Normal", "GpuEngineProvisioned", msg)
        set_status_ready(
            engine.status.conditions,
            engine.metadata.generation,
            "GpuEngineProvisioned",
            msg,
        )
        self.store.update_status(engine)
        return ReconcileResult()

    def build_gpu_engine_deployment(self, engine: Engine) -> Unstructured:
        gpu = engine.spec.driver.gpu
        ruleset_key = f"{engine.metadata.namespace}/{engine.spec.rule_set.name}"
        poll = (
            gpu.rule_set_cache_server.poll_interval_seconds
            if gpu.rule_set_cache_server is not None
            else DEFAULT_POLL_SECONDS
        )
        name = f"{GPU_ENGINE_NAME_PREFIX}{engine.metadata.name}"
        args = [
            f"--cache-server-instance={ruleset_key}",
            f"--cache-server-cluster={self.cache_server_cluster}",
            f"--cache-server-port={self.cache_server_port}",
            f"--rule-reload-interval-seconds={poll}",
            f"--failure-policy={engine.spec.failure_policy}",
            f"--max-batch-size={gpu.max_batch_size}",
            f"--max-batch-delay-ms={gpu.max_batch_delay_ms}",
            f"--drain-budget-seconds={GPU_ENGINE_DRAIN_BUDGET_SECONDS}",
            f"--extproc-port={gpu.ext_proc_port}",
            "--audit-log=-",  # SecAuditLog /dev/stdout parity; pod logs
        ]  # carry the audit stream the conformance runner matches against
        return Unstructured(
            kind="Deployment",
            api_version="apps/v1",
            metadata=ObjectMeta(
                name=name,
                namespace=engine.metadata.namespace,
                labels={"app": name},
                owner_references=self._owner_refs(engine),
            ),
            spec={
                "replicas": gpu.replicas,
                "selector": {"matchLabels": {"app": name}},
                "template": {
                    "metadata": {"labels": {"app": name}},
                    "spec": {
                        # Must cover preStop + drain budget + persist
                        # margin; the kubelet default (30) only happens to
                        # match — pin it so a default change elsewhere
                        # cannot silently truncate the drain.
                        "terminationGracePeriodSeconds": (
                            GPU_ENGINE_TERMINATION_GRACE_SECONDS
                        ),
                        "containers": [
                            {
                                "name": "gpu-engine",
                                "image": gpu.image,
                                "args": args,
                                "ports": [
                                    {"containerPort": 9090, "name": "http"},
                                    {
                                        "containerPort": gpu.ext_proc_port,
                                        "name": "extproc",
                                    },
                                ],
                                # Liveness = the process answers; readiness
                                # = a ruleset is loaded and the serving mode
                                # is not broken (sidecar/server.py). Split
                                # so Kubernetes stops ROUTING to a dead
                                # sidecar without RESTARTING one that is
                                # mid-compile.
                                "livenessProbe": {
                                    "httpGet": {
                                        "path": "/waf/v1/healthz",
                                        "port": "http",
                                    },
                                    "periodSeconds": 10,
                                },
                                "readinessProbe": {
                                    "httpGet": {
                                        "path": "/waf/v1/readyz",
                                        "port": "http",
                                    },
                                    "periodSeconds": 5,
                                },
                                "resources": {
                                    "limits": {"nvidia.com/gpu": "1"},
                                },
                                # Endpoint removal propagates while the
                                # pod sleeps; SIGTERM (and the sidecar's
                                # readyz 503 + drain) comes after.
                                "lifecycle": {
                                    "preStop": {
                                        "exec": {
                                            "command": [
                                                "sleep",
                                                str(
                                                    GPU_ENGINE_PRESTOP_SLEEP_SECONDS
                                                ),
                                            ]
                                        }
                                    }
                                },
                            }
                        ]
                    },
                },
            },
        )

    def build_gpu_engine_service(self, engine: Engine) -> Unstructured:
        """ClusterIP Service in front of the engine pods — the stable DNS
        name the EnvoyFilter's ext_proc cluster (and anything else in the
        mesh) dials instead of pod IPs."""
        gpu = engine.spec.driver.gpu
        name = f"{GPU_ENGINE_NAME_PREFIX}{engine.metadata.name}"
        return Unstructured(
            kind="Service",
            api_version="v1",
            metadata=ObjectMeta(
                name=name,
                namespace=engine.metadata.namespace,
                labels={"app": name},
                owner_references=self._owner_refs(engine),
            ),
            spec={
                "selector": {"app": name},
                "ports": [
                    {"name": "http", "port": 9090, "targetPort": "http"},
                    {
                        "name": "grpc-extproc",  # istio protocol sniffing
                        "port": gpu.ext_proc_port,
                        "targetPort": "extproc",
                    },
                ],
            },
        )

    def build_envoy_filter(self, engine: Engine) -> Unstructured:
        """EnvoyFilter attaching the engine to gateway traffic via ext_proc
        (docs/EXTPROC.md): one CLUSTER patch registering the engine Service
        as an http2 cluster, one HTTP_FILTER patch inserting
        ``envoy.filters.http.ext_proc`` before the router with the same
        processing mode the sidecar serves (request headers + buffered
        body, response side skipped). ``failure_mode_allow`` mirrors the
        Engine's failurePolicy so Envoy-side stream failures degrade the
        same way the engine itself would."""
        gpu = engine.spec.driver.gpu
        name = f"{GPU_ENGINE_NAME_PREFIX}{engine.metadata.name}"
        cluster_name = f"{name}-extproc"
        service_host = f"{name}.{engine.metadata.namespace}.svc.cluster.local"
        return Unstructured(
            kind="EnvoyFilter",
            api_version="networking.istio.io/v1alpha3",
            metadata=ObjectMeta(
                name=name,
                namespace=engine.metadata.namespace,
                labels={"app": name},
                owner_references=self._owner_refs(engine),
            ),
            spec={
                "workloadSelector": {
                    "labels": (
                        gpu.gateway_attachment.workload_selector or {}
                    ).get("matchLabels", {})
                },
                "configPatches": [
                    {
                        "applyTo": "CLUSTER",
                        "match": {"context": "GATEWAY"},
                        "patch": {
                            "operation": "ADD",
                            "value": {
                                "name": cluster_name,
                                "type": "STRICT_DNS",
                                "connect_timeout": "1s",
                                "typed_extension_protocol_options": {
                                    "envoy.extensions.upstreams.http.v3.HttpProtocolOptions": {
                                        "@type": (
                                            "type.googleapis.com/envoy.extensions."
                                            "upstreams.http.v3.HttpProtocolOptions"
                                        ),
                                        "explicit_http_config": {
                                            "http2_protocol_options": {}
                                        },
                                    }
                                },
                                "load_assignment": {
                                    "cluster_name": cluster_name,
                                    "endpoints": [
                                        {
                                            "lb_endpoints": [
                                                {
                                                    "endpoint": {
                                                        "address": {
                                                            "socket_address": {
                                                                "address": service_host,
                                                                "port_value": gpu.ext_proc_port,
                                                            }
                                                        }
                                                    }
                                                }
                                            ]
                                        }
                                    ],
                                },
                            },
                        },
                    },
                    {
                        "applyTo": "HTTP_FILTER",
                        "match": {
                            "context": "GATEWAY",
                            "listener": {
                                "filterChain": {
                                    "filter": {
                                        "name": "envoy.filters.network.http_connection_manager",
                                        "subFilter": {
                                            "name": "envoy.filters.http.router"
                                        },
                                    }
                                }
                            },
                        },
                        "patch": {
                            "operation": "INSERT_BEFORE",
                            "value": {
                                "name": "envoy.filters.http.ext_proc",
                                "typed_config": {
                                    "@type": (
                                        "type.googleapis.com/envoy.extensions."
                                        "filters.http.ext_proc.v3.ExternalProcessor"
                                    ),
                                    "grpc_service": {
                                        "envoy_grpc": {
                                            "cluster_name": cluster_name
                                        },
                                        "timeout": "5s",
                                    },
                                    "failure_mode_allow": (
                                        engine.spec.failure_policy == "allow"
                                    ),
                                    "processing_mode": {
                                        "request_header_mode": "SEND",
                                        "request_body_mode": "BUFFERED",
                                        "response_header_mode": "SKIP",
                                        "response_body_mode": "NONE",
                                    },
                                },
                            },
                        },
                    },
                ],
            },
        )

    def _owner_refs(self, engine: Engine) -> list[dict]:
        return [
            {
                "apiVersion": engine.api_version,
                "kind": engine.kind,
                "name": engine.metadata.name,
                "uid": engine.metadata.uid,
                "controller": True,
            }
        ]

    # -- failure path ---------------------------------------------------------

    def _invalid_configuration(self, engine: Engine, detail: str) -> ReconcileResult:
        msg = f"Invalid driver configuration: {detail}"
        self.recorder.event(engine, "Warning", "InvalidConfiguration", msg)
        set_status_degraded(
            engine.status.conditions,
            engine.metadata.generation,
            "InvalidConfiguration",
            msg,
        )
        self.store.update_status(engine)
        return ReconcileResult()
