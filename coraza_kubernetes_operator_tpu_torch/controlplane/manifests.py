"""Object ⇄ manifest-dict codec for the managed kinds.

Shared by the manifest-directory source (``cmd/operator.py``), the
Kubernetes API source (``kubeclient.py``) and the fake API server
(``kubeapi_fake.py``): one conversion, three transports. Field names
match the CRD YAML (and hence the reference Go types) exactly.
"""

from __future__ import annotations

from .api_types import (
    API_VERSION,
    ConfigMap,
    Condition,
    DriverConfig,
    Engine,
    EngineSpec,
    GatewayAttachmentConfig,
    IstioDriverConfig,
    IstioWasmConfig,
    ObjectMeta,
    RuleSet,
    RuleSetCacheServerConfig,
    RuleSetReference,
    RuleSetSpec,
    RuleSourceReference,
    GpuDriverConfig,
)


def meta_from_doc(doc: dict) -> ObjectMeta:
    meta_doc = doc.get("metadata", {}) or {}
    meta = ObjectMeta(
        name=meta_doc.get("name", ""),
        namespace=meta_doc.get("namespace", "default"),
        labels=meta_doc.get("labels", {}) or {},
        annotations=meta_doc.get("annotations", {}) or {},
    )
    if meta_doc.get("uid"):
        meta.uid = meta_doc["uid"]
    if meta_doc.get("generation"):
        meta.generation = int(meta_doc["generation"])
    if meta_doc.get("resourceVersion"):
        try:
            meta.resource_version = int(meta_doc["resourceVersion"])
        except ValueError:
            meta.resource_version = 0
    return meta


def _meta_to_doc(meta: ObjectMeta) -> dict:
    doc: dict = {"name": meta.name, "namespace": meta.namespace}
    if meta.labels:
        doc["labels"] = dict(meta.labels)
    if meta.annotations:
        doc["annotations"] = dict(meta.annotations)
    if meta.owner_references:
        doc["ownerReferences"] = [dict(o) for o in meta.owner_references]
    return doc


def _cache_server_from(doc: dict | None) -> RuleSetCacheServerConfig | None:
    if not doc:
        return None
    return RuleSetCacheServerConfig(
        poll_interval_seconds=int(doc.get("pollIntervalSeconds", 15))
    )


def object_from_manifest(doc: dict):
    """Manifest dict → typed object; None for unmanaged kinds."""
    kind = doc.get("kind")
    meta = meta_from_doc(doc)
    spec = doc.get("spec", {}) or {}
    if kind == "ConfigMap":
        return ConfigMap(metadata=meta, data=doc.get("data", {}) or {})
    if kind == "RuleSet":
        return RuleSet(
            metadata=meta,
            spec=RuleSetSpec(
                rules=[
                    RuleSourceReference(name=r.get("name", ""))
                    for r in spec.get("rules", [])
                ]
            ),
        )
    if kind == "Engine":
        driver_doc = spec.get("driver", {}) or {}
        driver = DriverConfig()
        if "istio" in driver_doc:
            wasm = (driver_doc["istio"] or {}).get("wasm", {}) or {}
            driver.istio = IstioDriverConfig(
                wasm=IstioWasmConfig(
                    image=wasm.get("image", ""),
                    mode=wasm.get("mode", "gateway"),
                    workload_selector=wasm.get("workloadSelector"),
                    rule_set_cache_server=_cache_server_from(
                        wasm.get("ruleSetCacheServer")
                    ),
                )
            )
        if "gpu" in driver_doc:
            gpu = driver_doc["gpu"] or {}
            attach_doc = gpu.get("gatewayAttachment")
            driver.gpu = GpuDriverConfig(
                image=gpu.get("image", GpuDriverConfig.image),
                replicas=int(gpu.get("replicas", 1)),
                max_batch_size=int(gpu.get("maxBatchSize", 2048)),
                max_batch_delay_ms=int(gpu.get("maxBatchDelayMs", GpuDriverConfig.max_batch_delay_ms)),
                ext_proc_port=int(
                    gpu.get("extProcPort", GpuDriverConfig.ext_proc_port)
                ),
                gateway_attachment=(
                    GatewayAttachmentConfig(
                        workload_selector=attach_doc.get("workloadSelector")
                    )
                    if attach_doc is not None
                    else None
                ),
                rule_set_cache_server=_cache_server_from(
                    gpu.get("ruleSetCacheServer")
                ),
            )
        return Engine(
            metadata=meta,
            spec=EngineSpec(
                rule_set=RuleSetReference(
                    name=(spec.get("ruleSet", {}) or {}).get("name", "")
                ),
                driver=driver,
                failure_policy=spec.get("failurePolicy", "fail"),
            ),
        )
    return None  # kinds we do not manage (Gateways etc.) are skipped


def object_to_manifest(obj) -> dict:
    """Typed object (or Unstructured) → manifest dict for the apiserver."""
    kind = obj.kind
    if kind == "ConfigMap":
        return {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": _meta_to_doc(obj.metadata),
            "data": dict(obj.data),
        }
    if kind == "RuleSet":
        return {
            "apiVersion": API_VERSION,
            "kind": "RuleSet",
            "metadata": _meta_to_doc(obj.metadata),
            "spec": {"rules": [{"name": r.name} for r in obj.spec.rules]},
        }
    if kind == "Engine":
        driver: dict = {}
        ist = obj.spec.driver.istio
        if ist is not None and ist.wasm is not None:
            wasm: dict = {"image": ist.wasm.image, "mode": ist.wasm.mode}
            if ist.wasm.workload_selector:
                wasm["workloadSelector"] = ist.wasm.workload_selector
            if ist.wasm.rule_set_cache_server:
                wasm["ruleSetCacheServer"] = {
                    "pollIntervalSeconds": ist.wasm.rule_set_cache_server.poll_interval_seconds
                }
            driver["istio"] = {"wasm": wasm}
        gpu = obj.spec.driver.gpu
        if gpu is not None:
            gpu_doc: dict = {
                "image": gpu.image,
                "replicas": gpu.replicas,
                "maxBatchSize": gpu.max_batch_size,
                "maxBatchDelayMs": gpu.max_batch_delay_ms,
                "extProcPort": gpu.ext_proc_port,
            }
            if gpu.gateway_attachment is not None:
                attach_doc: dict = {}
                if gpu.gateway_attachment.workload_selector:
                    attach_doc["workloadSelector"] = (
                        gpu.gateway_attachment.workload_selector
                    )
                gpu_doc["gatewayAttachment"] = attach_doc
            if gpu.rule_set_cache_server:
                gpu_doc["ruleSetCacheServer"] = {
                    "pollIntervalSeconds": gpu.rule_set_cache_server.poll_interval_seconds
                }
            driver["gpu"] = gpu_doc
        return {
            "apiVersion": API_VERSION,
            "kind": "Engine",
            "metadata": _meta_to_doc(obj.metadata),
            "spec": {
                "ruleSet": {"name": obj.spec.rule_set.name},
                "driver": driver,
                "failurePolicy": obj.spec.failure_policy,
            },
        }
    # Unstructured (WasmPlugin / Deployment / anything dynamic)
    return {
        "apiVersion": getattr(obj, "api_version", "v1"),
        "kind": kind,
        "metadata": _meta_to_doc(obj.metadata),
        "spec": dict(getattr(obj, "spec", {}) or {}),
    }


def status_to_doc(obj) -> dict:
    """Status subresource document for RuleSet / Engine."""
    conditions = [c.to_json() for c in getattr(obj.status, "conditions", [])]
    return {"status": {"conditions": conditions}}


def conditions_from_doc(doc: dict) -> list[Condition]:
    out = []
    for c in (doc.get("status", {}) or {}).get("conditions", []) or []:
        out.append(
            Condition(
                type=c.get("type", ""),
                status=c.get("status", "Unknown"),
                reason=c.get("reason", ""),
                message=c.get("message", ""),
                observed_generation=int(c.get("observedGeneration", 0)),
            )
        )
    return out
