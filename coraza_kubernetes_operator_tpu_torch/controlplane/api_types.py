"""API types for waf.k8s.coraza.io/v1alpha1 — Engine, RuleSet, driver configs.

Field-for-field parity with the reference CRDs (``api/v1alpha1/
ruleset_types.go``, ``engine_types.go``, ``engine_driver_types.go``,
``engine_driver_istio_types.go``), plus the ``gpu`` driver
(``spec.driver.gpu`` deploys the ``gpu-engine`` batch sidecar on an NVIDIA
card instead of an Istio WasmPlugin). ``validate()`` enforces the same constraints the
reference compiles into CRD schema + CEL rules — exactly-one driver,
exactly-one istio mode, oci:// image shape, selector required in gateway
mode, poll interval bounds, ≤2048 rule sources.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from datetime import datetime, timezone

GROUP = "waf.k8s.coraza.io"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"

MAX_RULE_SOURCES = 2048  # ruleset_types.go:99-101
MIN_POLL_SECONDS, MAX_POLL_SECONDS, DEFAULT_POLL_SECONDS = 1, 3600, 15
MAX_IMAGE_LEN = 1024  # engine_driver_istio_types.go:64-70
_IMAGE_RE = re.compile(r"^oci://")

VALIDATION_ANNOTATION = "coraza.io/validation"  # "false" skips rule validation


class ValidationError(ValueError):
    """Schema/CEL-equivalent rejection; message substrings mirror the CRD
    validation messages asserted in the reference envtest suite."""


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    generation: int = 1
    resource_version: int = 0
    uid: str = ""
    creation_timestamp: datetime = field(
        default_factory=lambda: datetime.now(timezone.utc)
    )
    owner_references: list[dict] = field(default_factory=list)
    deleted: bool = False

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.name)


@dataclass
class Condition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    observed_generation: int = 0
    last_transition_time: datetime = field(
        default_factory=lambda: datetime.now(timezone.utc)
    )

    def to_json(self) -> dict:
        return {
            "type": self.type,
            "status": self.status,
            "reason": self.reason,
            "message": self.message,
            "observedGeneration": self.observed_generation,
            "lastTransitionTime": self.last_transition_time.isoformat(),
        }


# ---------------------------------------------------------------------------
# ConfigMap (the rule source object, core/v1 parity subset)
# ---------------------------------------------------------------------------


@dataclass
class ConfigMap:
    metadata: ObjectMeta
    data: dict[str, str] = field(default_factory=dict)

    kind = "ConfigMap"
    api_version = "v1"


# ---------------------------------------------------------------------------
# RuleSet
# ---------------------------------------------------------------------------


@dataclass
class RuleSourceReference:
    name: str


@dataclass
class RuleSetCacheServerConfig:
    poll_interval_seconds: int = DEFAULT_POLL_SECONDS


@dataclass
class RuleSetSpec:
    rules: list[RuleSourceReference] = field(default_factory=list)


@dataclass
class RuleSetStatus:
    """Condition types (tri-state machine in ``conditions.py``):

    - ``Ready``: rules parsed, compiled for the GPU engine, and cached.
    - ``Progressing`` / ``Degraded``: reconcile in flight / failed.
    - ``Analyzed``: static-analysis verdict for the aggregated document
      (docs/ANALYSIS.md). True ⇒ zero error-severity findings; False ⇒
      reason ``ErrorFindings`` (counts in the message — the sidecar's
      reload gate will refuse a swap that introduces new ones) or
      ``AnalysisError`` (the analyzer itself crashed). Advisory: it never
      blocks Ready, so a flagged ruleset still serves while the operator
      decides."""

    conditions: list[Condition] = field(default_factory=list)


@dataclass
class RuleSet:
    metadata: ObjectMeta
    spec: RuleSetSpec = field(default_factory=RuleSetSpec)
    status: RuleSetStatus = field(default_factory=RuleSetStatus)

    kind = "RuleSet"
    api_version = API_VERSION

    def validate(self) -> None:
        if not self.metadata.name:
            raise ValidationError("metadata.name is required")
        if not self.spec.rules:
            raise ValidationError("spec.rules must contain at least 1 item")
        if len(self.spec.rules) > MAX_RULE_SOURCES:
            raise ValidationError(
                f"spec.rules must contain at most {MAX_RULE_SOURCES} items"
            )
        for ref in self.spec.rules:
            if not ref.name:
                raise ValidationError("spec.rules[].name is required")


# ---------------------------------------------------------------------------
# Engine + drivers
# ---------------------------------------------------------------------------


@dataclass
class RuleSetReference:
    name: str


@dataclass
class IstioWasmConfig:
    image: str = ""
    mode: str = "gateway"  # IstioIntegrationMode (gateway is the only mode)
    workload_selector: dict | None = None  # {"matchLabels": {...}}
    rule_set_cache_server: RuleSetCacheServerConfig | None = None

    def validate(self) -> None:
        if not self.image:
            raise ValidationError("driver.istio.wasm.image is required")
        if not _IMAGE_RE.match(self.image):
            raise ValidationError('image must match the pattern "^oci://"')
        if len(self.image) > MAX_IMAGE_LEN:
            raise ValidationError(
                f"image must be at most {MAX_IMAGE_LEN} characters"
            )
        if self.mode not in ("gateway",):
            raise ValidationError(f"unsupported istio integration mode {self.mode!r}")
        if self.mode == "gateway" and not (
            self.workload_selector and self.workload_selector.get("matchLabels")
        ):
            raise ValidationError(
                "workloadSelector is required when mode is gateway"
            )
        if self.rule_set_cache_server is not None:
            poll = self.rule_set_cache_server.poll_interval_seconds
            if not MIN_POLL_SECONDS <= poll <= MAX_POLL_SECONDS:
                raise ValidationError(
                    f"pollIntervalSeconds must be between {MIN_POLL_SECONDS} and {MAX_POLL_SECONDS}"
                )


@dataclass
class IstioDriverConfig:
    wasm: IstioWasmConfig | None = None

    def validate(self) -> None:
        modes = [m for m in (self.wasm,) if m is not None]
        if len(modes) != 1:
            raise ValidationError("exactly one istio integration mode must be set")
        self.wasm.validate()


@dataclass
class GatewayAttachmentConfig:
    """Attach the gpu-engine to live gateway traffic via Envoy ext_proc
    (docs/EXTPROC.md): the controller renders an ``EnvoyFilter`` that
    registers the engine Service as an ext_proc cluster and inserts the
    ``envoy.filters.http.ext_proc`` HTTP filter on the selected gateway
    workloads — the reference's ``pluginConfig`` wiring, rebuilt for the
    first-party data plane."""

    # Istio workloadSelector for the gateway pods, {"matchLabels": {...}}
    # — same shape the WasmPlugin gateway mode requires.
    workload_selector: dict | None = None

    def validate(self) -> None:
        if not (self.workload_selector and self.workload_selector.get("matchLabels")):
            raise ValidationError(
                "gatewayAttachment.workloadSelector is required"
            )


@dataclass
class GpuDriverConfig:
    """The batch engine mode: deploys the ``gpu-engine`` sidecar that
    evaluates batched requests on one NVIDIA card and polls the ruleset
    cache for hot reload."""

    image: str = "ghcr.io/coraza-tpu/gpu-engine:latest"
    replicas: int = 1
    rule_set_cache_server: RuleSetCacheServerConfig | None = None
    max_batch_size: int = 2048
    # 100, not 2: a window costs about the same host time whatever its
    # size, so on the card 1 ms windows hold a few requests and serve a
    # fraction of what 100 ms windows do (PERF.md, "sidecar on the card").
    max_batch_delay_ms: int = 100
    # ext_proc gRPC port on the engine pods/Service (docs/EXTPROC.md).
    ext_proc_port: int = 9091
    # When set, the engine is attached to gateway traffic with an
    # EnvoyFilter; absent, the ext_proc listener still opens but nothing
    # routes to it until an operator wires their own filter.
    gateway_attachment: GatewayAttachmentConfig | None = None

    def validate(self) -> None:
        if self.replicas < 1:
            raise ValidationError("driver.gpu.replicas must be >= 1")
        if not 1 <= self.max_batch_size <= 1 << 20:
            raise ValidationError("driver.gpu.maxBatchSize out of range")
        if not 1 <= self.ext_proc_port <= 65535:
            raise ValidationError("driver.gpu.extProcPort out of range")
        if self.ext_proc_port == 9090:
            raise ValidationError(
                "driver.gpu.extProcPort collides with the HTTP port 9090"
            )
        if self.gateway_attachment is not None:
            self.gateway_attachment.validate()
        if self.rule_set_cache_server is not None:
            poll = self.rule_set_cache_server.poll_interval_seconds
            if not MIN_POLL_SECONDS <= poll <= MAX_POLL_SECONDS:
                raise ValidationError(
                    f"pollIntervalSeconds must be between {MIN_POLL_SECONDS} and {MAX_POLL_SECONDS}"
                )


@dataclass
class DriverConfig:
    istio: IstioDriverConfig | None = None
    gpu: GpuDriverConfig | None = None

    def validate(self) -> None:
        drivers = [d for d in (self.istio, self.gpu) if d is not None]
        if len(drivers) != 1:
            raise ValidationError("exactly one driver must be configured")
        drivers[0].validate()


@dataclass
class EngineSpec:
    rule_set: RuleSetReference = field(default_factory=lambda: RuleSetReference(""))
    driver: DriverConfig = field(default_factory=DriverConfig)
    failure_policy: str = "fail"  # fail | allow (engine_types.go:153-166)


@dataclass
class EngineStatus:
    conditions: list[Condition] = field(default_factory=list)


@dataclass
class Engine:
    metadata: ObjectMeta
    spec: EngineSpec = field(default_factory=EngineSpec)
    status: EngineStatus = field(default_factory=EngineStatus)

    kind = "Engine"
    api_version = API_VERSION

    def validate(self) -> None:
        if not self.metadata.name:
            raise ValidationError("metadata.name is required")
        if not self.spec.rule_set.name:
            raise ValidationError("spec.ruleSet.name is required")
        if self.spec.failure_policy not in ("fail", "allow"):
            raise ValidationError(
                'failurePolicy must be one of "fail", "allow"'
            )
        self.spec.driver.validate()
